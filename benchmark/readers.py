"""Readings that more than one metric file takes, each from a finished
``loadgen.Run``; ``None`` where the run has nothing to read."""

from __future__ import annotations

from typing import Optional

import numpy as np

from benchmark import roofline, tracing


def gflops(run) -> Optional[float]:
    """2*nnz*K operations per call completed in the window over the
    window's wall time."""
    if not run.calls:
        return None
    return roofline.call_flops(run.nnz, run.k) * run.calls / run.window_s / 1e9


def call_ms_p95(run) -> Optional[float]:
    """The 95th percentile of every call's span in the window."""
    if run.spans_ms is None or not len(run.spans_ms):
        return None
    return float(np.percentile(run.spans_ms, 95))


def _traced(run) -> Optional[dict]:
    t = run.traced
    return t if t and t["kernels"] else None


def _device_ms(run, hand: bool) -> Optional[float]:
    t = _traced(run)
    if t is None:
        return None
    us = sum(end - start for name, start, end in t["kernels"]
             if tracing.is_hand(name, t["hand"]) == hand)
    return us / 1e3 / t["calls"] if us else None


def hand_ms(run) -> Optional[float]:
    """Device ms per call of the port's hand kernels."""
    return _device_ms(run, True)


def torch_ops_ms(run) -> Optional[float]:
    """Device ms per call of every other device operation."""
    return _device_ms(run, False)


def idle_pct(run) -> Optional[float]:
    """The share of the traced window with no device operation running."""
    t = _traced(run)
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_pct(run) -> Optional[float]:
    """The call's bound over the device busy time per call."""
    t = _traced(run)
    if t is None or t["busy_s"] <= 0:
        return None
    bound = roofline.call_bound_s(run.m, run.n, run.nnz, run.k,
                                  run.device_name)
    if bound is None:
        return None
    return 100.0 * bound / (t["busy_s"] / t["calls"])
