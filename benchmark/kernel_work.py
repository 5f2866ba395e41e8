"""The yardstick of one launch of a tile kernel: its operations, its bytes,
and the least time a card could take for them, with the formula of the
port's ``dense_kernels.tile_work``, kept here so that the yardstick does
not move with the program.

``tiles`` tiles of ``rows x cols`` output slots at depth ``k``:
``2 * tiles * rows * cols * k`` operations, each computed in ``passes``
TF32 passes (3: hi*hi, lo*hi, hi*lo; 1: hi*hi) on the tensor cores.
Bytes: every operand row the launch references counted once (``a_rows``
rows of A and ``b_rows`` rows of B, ``k`` fp32 values each), its index
arrays (``index_bytes``) once, and every output slot once, padding
included. Rows the kernel reads again (B sits in L2 at these sizes) are
not counted again, so the share of this bound stays at or under 100%.
"""

from __future__ import annotations

from typing import Optional

from benchmark import roofline


def tile_flops(tiles: int, rows: int, cols: int, k: int) -> int:
    """Operations of the launch: a multiply and an add per term."""
    return 2 * tiles * rows * cols * k


def tile_bytes(tiles: int, rows: int, cols: int, k: int, a_rows: int,
               b_rows: int, index_bytes: int, out_bytes: int = 4) -> int:
    """Bytes the launch must move: the referenced operand rows, the index
    arrays and the output slots, each once."""
    return (tiles * rows * cols * out_bytes + 4 * k * (a_rows + b_rows)
            + index_bytes)


def tile_bound_s(tiles: int, rows: int, cols: int, k: int, a_rows: int,
                 b_rows: int, index_bytes: int, passes: int,
                 device_name: str, out_bytes: int = 4) -> Optional[float]:
    """The least seconds the launch takes on the named card: the larger of
    its operations at ``passes`` TF32 passes over the TF32 peak and its
    bytes over the memory rate; None on a card without a table entry."""
    peak = roofline.peaks(device_name)
    if peak is None:
        return None
    flops, bandwidth = peak
    return max(passes * tile_flops(tiles, rows, cols, k) / flops,
               tile_bytes(tiles, rows, cols, k, a_rows, b_rows, index_bytes,
                          out_bytes) / bandwidth)
