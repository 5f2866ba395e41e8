"""The call's share of its roofline: the least time the card could take for
the SDDMM's own work (``benchmark/roofline.py``) over the device busy time
(union of operation intervals) per traced call."""

from benchmark.readers import roofline_pct as read  # noqa: F401
