"""The share of the traced window in which no device operation runs,
100 - 100 * (union of operation intervals) / (traced window)."""

from benchmark.readers import idle_pct as read  # noqa: F401
