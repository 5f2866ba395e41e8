"""Reduction of a ``torch.profiler`` trace to the benchmark's readings.

The method of the port's ``chip_smoke.py [profile]`` (device busy as the
union of kernel intervals, which counts two overlapping streams once),
copied here so that the yardstick does not move with the program:

- ``kernels``: every device activity of the trace (kernels, copies, fills)
  as ``(name, start_us, end_us)``, without user annotations;
- ``union_us``: the time in which at least one of them runs;
- ``breakdown``: the device operations that took most time, and the idle
  gaps between them grouped by the host operation that was running at the
  middle of the gap (``"host between ops"`` where none was: Python, or a
  ctypes launch of a hand kernel).
"""

from __future__ import annotations

import bisect
import glob
import os
import re
from typing import Dict, List, Tuple

Interval = Tuple[str, float, float]

#: idle gaps shorter than this (microseconds) are launch latency, not idle
MIN_GAP_US = 1.0


_GLOBAL = re.compile(r"__global__\s+void\s+"
                     r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def hand_kernel_names(package_dir: str) -> Tuple[str, ...]:
    """The ``__global__`` functions of the program's CUDA sources
    (``<package>/csrc/*.cu``): the port's hand kernels, whose names the
    device trace shows."""
    names = set()
    for path in glob.glob(os.path.join(package_dir, "csrc", "*.cu")):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return tuple(sorted(names))


def is_hand(name: str, hand: Tuple[str, ...]) -> bool:
    """Whether the device operation ``name`` is one of the hand kernels
    (a name such as ``void bsr_resident_kernel<32, 128>(...)``)."""
    return re.search(r"\b(" + "|".join(hand) + r")\b", name) is not None \
        if hand else False


def _is_annotation(event) -> bool:
    return bool(getattr(event, "is_user_annotation", False))


def kernels(prof) -> List[Interval]:
    """Device activities of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not _is_annotation(e)),
                  key=lambda iv: iv[1])


def host_ops(prof) -> List[Interval]:
    """Top-level host operations (no host parent), by start."""
    from torch.autograd import DeviceType
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CPU
                   and e.cpu_parent is None),
                  key=lambda iv: iv[1])


def busy_segments(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals as disjoint (start, end) segments."""
    segments: List[Tuple[float, float]] = []
    for _, start, end in sorted(intervals, key=lambda iv: iv[1]):
        if segments and start <= segments[-1][1]:
            if end > segments[-1][1]:
                segments[-1] = (segments[-1][0], end)
        else:
            segments.append((start, end))
    return segments


def union_us(intervals: List[Interval]) -> float:
    return sum(end - start for start, end in busy_segments(intervals))


def time_by_name(intervals: List[Interval]) -> Dict[str, float]:
    """Summed microseconds of each device operation name."""
    out: Dict[str, float] = {}
    for name, start, end in intervals:
        out[name] = out.get(name, 0.0) + (end - start)
    return out


def _label_at(ops: List[Interval], starts: List[float], t: float) -> str:
    """The host operation running at time ``t``, if one was."""
    i = bisect.bisect_right(starts, t)
    # top-level ops of one thread do not overlap: the latest to start
    # before t is the one that can cover it; a few more for other threads
    for name, _, end in reversed(ops[max(i - 4, 0):i]):
        if end >= t:
            return name
    return "host between ops"


def idle_gaps(intervals: List[Interval], ops: List[Interval]
              ) -> Dict[str, float]:
    """Microseconds of device idle between busy segments, by the host
    operation running at each gap's middle."""
    segments = busy_segments(intervals)
    starts = [op[1] for op in ops]
    out: Dict[str, float] = {}
    for (_, end), (start, _) in zip(segments, segments[1:]):
        gap = start - end
        if gap < MIN_GAP_US:
            continue
        label = _label_at(ops, starts, end + gap / 2)
        out[label] = out.get(label, 0.0) + gap
    return out


def top(by_name: Dict[str, float], n: int = 10) -> list:
    """The ``n`` largest entries as ``[name, seconds]``, largest first."""
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:200], us / 1e6] for name, us in rows]
