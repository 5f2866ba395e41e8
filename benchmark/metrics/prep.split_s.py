"""The column split of a preprocessing: the program's span ``prep.split``
whose parent is one of the last ``PREP_REPEATS`` ``prep.plan`` roots, the
least of them. The split that set-up recomputes after the timed span is a
root of its own and is not read."""

from benchmark.loadgen import PREP_REPEATS


def read(run):
    from bsmr_sddmm_tpu_torch.utils import profiling
    if not hasattr(profiling, "spans"):
        return None                     # a program without spans
    spans = profiling.spans()
    roots = {s.id for s in [s for s in spans if s.name == "prep.plan"
                            and s.parent is None][-PREP_REPEATS:]}
    times = [s.duration_ns for s in spans
             if s.name == "prep.split" and s.parent in roots]
    return min(times) / 1e9 if times else None
