"""Kernel timing.

The CUDA original times with CUDA events averaged over ``num_iterations``
(include/CudaTimeCalculator.cuh:14-54, src/sddmmKernel.cu:2561-2659), and so
does :func:`time_cuda`. :func:`time_cuda_graph` times the replay of a CUDA
graph of one call, for calls whose device work is shorter than their host
enqueue. :func:`time_host` is the same loop on the host clock for CPU
tensors; its numbers are CPU times and are never device metrics.
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


#: seconds of graph replays before a graph is timed
GRAPH_WARMUP_S = 0.2
#: rounds of timed replays; time_cuda_graph returns their median
GRAPH_ROUNDS = 5


def time_cuda_graph(fn: Callable, *args,
                    iterations: int = 50) -> Tuple[float, object]:
    """Milliseconds per replay of a CUDA graph captured from one call of
    ``fn(*args)``: the median over ``GRAPH_ROUNDS`` rounds of the mean of
    ``iterations`` back-to-back replays; and that call's result.

    A replay is one host launch for the whole call, so this is the call's
    device time even where ``time_cuda`` would measure the host enqueueing
    its ops one by one (a lone tier of a small plan). ``fn`` must be
    capturable: every op on the current stream, no host synchronisation.
    The graph replays for ``GRAPH_WARMUP_S`` seconds first, so that the
    card's clocks, low after host-only work, are up when the timing
    starts; the median drops a round that still caught them low."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda_graph needs a CUDA device")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)                   # lazy kernel build, allocator warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    end = time.perf_counter() + GRAPH_WARMUP_S
    while time.perf_counter() < end:
        for _ in range(iterations):
            graph.replay()
        torch.cuda.synchronize()
    times = sorted(time_cuda(graph.replay, iterations=iterations)[0]
                   for _ in range(GRAPH_ROUNDS))
    return times[len(times) // 2], out


def time_host(fn: Callable, *args, iterations: int = 10) -> Tuple[float, object]:
    """Mean milliseconds per call of ``fn(*args)`` on the host clock after
    one warm-up call (CPU tensors only), and the last call's result."""
    out = fn(*args)
    t0 = time.perf_counter()
    for _ in range(iterations):
        out = fn(*args)
    return (time.perf_counter() - t0) * 1e3 / max(iterations, 1), out
