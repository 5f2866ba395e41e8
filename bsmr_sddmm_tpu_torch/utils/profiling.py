"""Profiling hooks.

The counterpart of ``bsmr_sddmm_tpu.utils.profiling``. The CUDA original's
only profiling mechanism is CUDA-event phase timers flowing into the Logger
(include/CudaTimeCalculator.cuh:14-54). Here:

* phase wall timers with the same Logger integration (`phase_timer`, a
  copy),
* a `torch.profiler` trace of the host and the card around a block,
  written as a Chrome trace into ``log_dir`` (`trace`, the counterpart of
  the JAX package's `jax.profiler` capture),
* per-call device timing via utils.timing (CUDA events, graph replay).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator


@contextlib.contextmanager
def phase_timer(sink: Dict[str, float], name: str) -> Iterator[None]:
    """Accumulate the wall time of a pipeline phase into ``sink`` (ms),
    like the reference's per-phase CudaTimeCalculator fields."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink[name] = sink.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace (host, and the card where there
    is one) around the enclosed block; on exit it is written to
    ``<log_dir>/trace.json`` (open in chrome://tracing or Perfetto). Yields
    that path."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
