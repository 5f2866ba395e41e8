"""Device time per call of every device operation that is not a hand
kernel (the row gather, the gathered tier's ``index_select`` and ``bmm``,
the residual, the CSR emission's ``cat`` and ``index_select``), from the
profiler's trace."""

from benchmark.readers import torch_ops_ms as read  # noqa: F401
