"""The dense tier's share of its roofline in a cell whose dense tier is the
gathered-tile kernel (``col_mode="reorder"``): the least time the card
could take for the work of the tier's launch (``benchmark/kernel_work.py``,
from the program's counters ``body.dense.tiles``, ``.a_rows``,
``.b_rows``, ``.index_bytes``, ``body.tile.rows``, ``body.tile.cols`` and
``body.passes`` of the last body built, fp32 output) over the device time
per traced call of ``gathered_tile_kernel``. ``None`` where the program
records no such counters, where that kernel did not run, or where the fused
gathered tier launched it too (then its time is not the dense tier's)."""

import re

from benchmark import kernel_work

KERNEL = re.compile(r"\bgathered_tile_kernel\b")
COUNTERS = ("body.dense.tiles", "body.dense.a_rows", "body.dense.b_rows",
            "body.dense.index_bytes", "body.tile.rows", "body.tile.cols",
            "body.passes")


def read(run):
    from bsmr_sddmm_tpu_torch.utils import profiling
    if not hasattr(profiling, "counters"):
        return None                     # a program without counters
    got = profiling.counters()
    if any(name not in got for name in COUNTERS) \
            or run.counters.get("fused_gathered.launches"):
        return None
    t = run.traced
    if not t or not t["calls"]:
        return None
    us = sum(end - start for name, start, end in t["kernels"]
             if KERNEL.search(name))
    if not us:
        return None
    bound = kernel_work.tile_bound_s(
        got["body.dense.tiles"], got["body.tile.rows"],
        got["body.tile.cols"], run.k, got["body.dense.a_rows"],
        got["body.dense.b_rows"], got["body.dense.index_bytes"],
        got["body.passes"], run.device_name)
    if bound is None:
        return None
    return 100.0 * bound / (us / 1e6 / t["calls"])
