"""Kernel timing.

The CUDA original times with CUDA events averaged over ``num_iterations``
(include/CudaTimeCalculator.cuh:14-54, src/sddmmKernel.cu:2561-2659), and so
does :func:`time_cuda`. :func:`time_host` is the same loop on the host clock
for CPU tensors; its numbers are CPU times and are never device metrics.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch


def time_cuda(fn: Callable, *args, iterations: int = 10) -> Tuple[float, object]:
    """Mean milliseconds per call of ``fn(*args)`` on the current CUDA
    stream, after one warm-up call, and the last call's result.

    CUDA events bracket ``iterations`` back-to-back calls; the host
    synchronises once, after the end event."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    out = fn(*args)                       # warm-up (and lazy kernel build)
    stream = torch.cuda.current_stream()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    for _ in range(iterations):
        out = fn(*args)
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / max(iterations, 1), out


def time_host(fn: Callable, *args, iterations: int = 10) -> Tuple[float, object]:
    """Mean milliseconds per call of ``fn(*args)`` on the host clock after
    one warm-up call (CPU tensors only), and the last call's result."""
    out = fn(*args)
    t0 = time.perf_counter()
    for _ in range(iterations):
        out = fn(*args)
    return (time.perf_counter() - t0) * 1e3 / max(iterations, 1), out
