"""The program's host timers of the row clustering and the column split
(``BsmrReordering.row_time_ms + col_time_ms``), the least over the
preprocessing repeats of set-up."""


def read(run):
    return min(run.prep_reorder_ms) / 1e3 if run.prep_reorder_ms else None
