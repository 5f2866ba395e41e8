"""The benchmark's yardstick of one SDDMM call: its operations, its bytes,
and the least time a card could take for them.

The work is the SDDMM's own, whatever implements it: ``2 * nnz * K``
operations, and each byte that the call must move counted once: A
(M x K fp32), B (N x K fp32), the mask's int32 column indices and row
offsets, and the fp32 output. Padded tiles, gathers and TF32 passes of the
program do not count, so a change of tiling does not change the yardstick.

Peaks are NVIDIA's data-sheet numbers for the H100 SXM (dense, no
sparsity) at its full 700 W; the card's power limit is printed beside every
run. A card the table does not name has no bound: the readers of roofline
shares then report nothing.
"""

from __future__ import annotations

from typing import Optional

#: device-name fragment -> (TF32 tensor FLOP/s, HBM bytes/s)
PEAKS = {
    "H100": (495e12, 3.35e12),
}


def peaks(device_name: str) -> Optional[tuple]:
    """(FLOP/s, bytes/s) of the card named ``device_name``, else None."""
    for fragment, peak in PEAKS.items():
        if fragment in device_name:
            return peak
    return None


def call_flops(nnz: int, k: int) -> int:
    """Operations of one call: a multiply and an add per term."""
    return 2 * nnz * k


def call_bytes(m: int, n: int, nnz: int, k: int, out_bytes: int = 4) -> int:
    """Bytes one call must move: A, B, the mask's column indices and row
    offsets (int32), and the output, each once."""
    return 4 * m * k + 4 * n * k + 4 * nnz + 4 * (m + 1) + out_bytes * nnz


def call_bound_s(m: int, n: int, nnz: int, k: int, device_name: str,
                 out_bytes: int = 4) -> Optional[float]:
    """The least seconds a call takes on the named card: the larger of its
    operations over peak FLOP/s and its bytes over peak bandwidth; None on
    a card without a table entry."""
    peak = peaks(device_name)
    if peak is None:
        return None
    flops, bandwidth = peak
    return max(call_flops(nnz, k) / flops,
               call_bytes(m, n, nnz, k, out_bytes) / bandwidth)
