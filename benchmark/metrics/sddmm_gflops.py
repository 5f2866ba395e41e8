"""Throughput of the SDDMM calls on a reused mask: 2*nnz*K operations per
call completed in the window over the window's wall time (which ends at a
synchronize after the last call)."""

from benchmark.readers import gflops as read  # noqa: F401
