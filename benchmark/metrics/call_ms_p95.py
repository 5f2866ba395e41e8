"""The 95th percentile, over every call of the window, of a call's span
between CUDA events recorded on the calling stream right before and right
after it (the device's time of a replay)."""

from benchmark.readers import call_ms_p95 as read  # noqa: F401
