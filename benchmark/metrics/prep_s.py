"""Preprocessing of a new mask, from the CSR in host memory to the plan on
the card: ``plan()`` (row clustering, column split, packing),
``device_plan()`` and a synchronize, each time on a new pipeline; the
fastest of the repeats in set-up."""


def read(run):
    return min(run.prep_s) if run.prep_s else None
