"""The plan's upload to the card: the program's span ``prep.upload``
(``ops.sddmm.device_plan``, which ends at a synchronize), the least of the
last ``PREP_REPEATS``."""

from benchmark.loadgen import PREP_REPEATS


def read(run):
    from bsmr_sddmm_tpu_torch.utils import profiling
    if not hasattr(profiling, "spans"):
        return None                     # a program without spans
    times = [s.duration_ns for s in profiling.spans()
             if s.name == "prep.upload"][-PREP_REPEATS:]
    return min(times) / 1e9 if times else None
