"""The program's host timer of tile packing (``TilePlan.pack_time_ms``),
the least over the preprocessing repeats of set-up."""


def read(run):
    return min(run.prep_pack_ms) / 1e3 if run.prep_pack_ms else None
