"""Device time per call of the port's own CUDA kernels (the ``__global__``
functions of its ``csrc/``), matched by name in the profiler's trace."""

from benchmark.readers import hand_ms as read  # noqa: F401
