"""The share of the body's computed output slots that hold a nonzero:
100 * ``body.nnz`` over the sum of ``body.slots.{dense,packed,gathered,
residual}`` (the four tiers' padded slots), the program's counters of the
last body built."""

TIERS = ("dense", "packed", "gathered", "residual")


def read(run):
    from bsmr_sddmm_tpu_torch.utils import profiling
    if not hasattr(profiling, "counters"):
        return None                     # a program without counters
    got = profiling.counters()
    slots = sum(got.get(f"body.slots.{tier}", 0) for tier in TIERS)
    if "body.nnz" not in got or not slots:
        return None
    return 100.0 * got["body.nnz"] / slots
