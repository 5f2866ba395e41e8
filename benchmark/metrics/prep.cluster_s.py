"""The row clustering of a preprocessing: the program's span
``prep.cluster`` (encoding, dispersion, sort, greedy clustering), the
least under the last ``PREP_REPEATS`` ``prep.plan`` roots, which are the
preprocessings of set-up."""

from benchmark.loadgen import PREP_REPEATS


def read(run):
    from bsmr_sddmm_tpu_torch.utils import profiling
    if not hasattr(profiling, "spans"):
        return None                     # a program without spans
    spans = profiling.spans()
    roots = {s.id for s in [s for s in spans if s.name == "prep.plan"
                            and s.parent is None][-PREP_REPEATS:]}
    times = [s.duration_ns for s in spans
             if s.name == "prep.cluster" and s.root in roots]
    return min(times) / 1e9 if times else None
