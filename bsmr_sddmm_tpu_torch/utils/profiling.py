"""Spans, counters and traces of the port.

The counterpart of ``bsmr_sddmm_tpu.utils.profiling``. The CUDA original's
only profiling mechanism is CUDA-event phase timers flowing into the Logger
(include/CudaTimeCalculator.cuh:14-54). Here one store, in memory and
bounded (:data:`CAPACITY` records of each kind), holds:

* host spans (:class:`span`): a name, a start and an end on
  ``time.perf_counter_ns``, the parent span (a per-thread stack) and the
  root span's id, which is one per request (a preprocessing, a body call).
  Each span also opens ``torch.profiler.record_function("bsmr::" + name)``,
  so that under a ``torch.profiler`` session it lies on the profiler's
  clock beside the device activities. :meth:`Span.phase` opens children
  one after another, each ending where the next begins;
* device spans of the SDDMM body's tiers (:func:`device_spans`): a pair of
  timing CUDA events around each tier, recorded on the stream the tier
  runs on, only while recording is on (:class:`record`). Under CUDA-graph
  capture the events are external, so the graph holds their record nodes
  and every replay records them again; :func:`device_spans` reads the last
  replay of every captured call. Eager calls take their events from a
  pool. Each read synchronizes and records an anchor event at a known
  ``perf_counter_ns``, which puts the device spans on the host clock;
* counters (:func:`count`), and a snapshot (:func:`counters`) that also
  reads, where they live and under their own names, the kernel launch
  counters (``<op>.launches``, ``bsr_dense.route.<route>``), the bodies'
  ``forks`` and ``parallel.collectives.COUNTS``.

:func:`write` writes the store as ``spans.json``; :func:`trace` captures a
``torch.profiler`` trace around a block, with recording on, and writes
``trace.json`` and the block's ``spans.json``; :func:`phase_timer` adds a
span's milliseconds to a Logger-style sink; :func:`body_span` is a span
while recording is on and only its profiler range while it is off. Setting
``BSMR_TORCH_TRACE=<dir>`` turns recording on when this module is imported
and writes ``<dir>/spans.json`` when the process exits.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import itertools
import json
import os
import sys
import threading
import time
import weakref
from typing import Dict, Iterator, List, Optional

import torch
from torch.profiler import record_function

#: records of each kind (host spans, read device spans, counter records)
#: the store keeps; the oldest go first
CAPACITY = 1 << 16
#: eager body calls whose events wait to be read; one more reads them all
MAX_PENDING = 4096
#: captured body calls whose events every read reads again
MAX_CAPTURED = 1024
#: the environment variable that traces a whole process
TRACE_ENV = "BSMR_TORCH_TRACE"

#: whether body calls record their tier spans (see :class:`record`)
RECORDING = False

_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_host: collections.deque = collections.deque(maxlen=CAPACITY)
_device: collections.deque = collections.deque(maxlen=CAPACITY)
_counts: collections.deque = collections.deque(maxlen=CAPACITY)
_pending: collections.deque = collections.deque()
_captured: collections.deque = collections.deque(maxlen=MAX_CAPTURED)
_pool: list = []
_bodies: "weakref.WeakSet" = weakref.WeakSet()
#: CUDA events made for body spans (pooled ones are reused, not made)
events_made = 0


class Span:
    """One host span; ``end_ns`` is None while it is open."""

    __slots__ = ("id", "name", "parent", "root", "thread", "start_ns",
                 "end_ns", "_rf", "_phase")

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def duration_ms(self) -> float:
        return self.duration_ns / 1e6

    def phase(self, name: str) -> "Span":
        """End this span's open phase, if any, and open the child
        ``<name of this span>.<name>``; the last phase ends with this
        span."""
        t = time.perf_counter_ns()
        if self._phase is not None:
            _close(self._phase, t)
        self._phase = _open(f"{self.name}.{name}", self, t)
        return self._phase

    def as_dict(self) -> dict:
        return dict(id=self.id, name=self.name, parent=self.parent,
                    root=self.root, thread=self.thread,
                    start_ns=self.start_ns, end_ns=self.end_ns)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _open(name: str, parent: Optional[Span] = None,
          start_ns: Optional[int] = None) -> Span:
    stack = _stack()
    if parent is None and stack:
        parent = stack[-1]
    s = Span()
    s.id = next(_ids)
    s.name = name
    s.parent = parent.id if parent is not None else None
    s.root = parent.root if parent is not None else s.id
    s.thread = threading.get_ident()
    s._phase = None
    s._rf = record_function("bsmr::" + name)
    s._rf.__enter__()
    stack.append(s)
    s.end_ns = None
    s.start_ns = time.perf_counter_ns() if start_ns is None else start_ns
    return s


def _close(s: Span, end_ns: Optional[int] = None) -> None:
    t = time.perf_counter_ns() if end_ns is None else end_ns
    if s._phase is not None:
        _close(s._phase, t)
        s._phase = None
    s.end_ns = t
    stack = _stack()
    if stack and stack[-1] is s:
        stack.pop()
    elif s in stack:
        stack.remove(s)
    s._rf.__exit__(None, None, None)
    s._rf = None
    _host.append(s)


class span:
    """``with span(name) as s:`` records the enclosed block as a host span
    (see the module's docstring); ``s.duration_ms`` after the block."""

    __slots__ = ("_name", "_span")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self) -> Span:
        self._span = _open(self._name)
        return self._span

    def __exit__(self, *exc) -> bool:
        _close(self._span)
        return False


#: the context a body call opens for each of its parts while recording is
#: off: it records nothing (see :func:`no_span`)
NO_SPAN = contextlib.nullcontext()


def no_span(name: str) -> contextlib.nullcontext:
    """:data:`NO_SPAN`, for any ``name``: the tier context of a body call
    while recording is off, in place of :meth:`body_call.tier`."""
    return NO_SPAN


def body_span(name: str):
    """``span(name)`` while recording is on; off, only its profiler range
    ``bsmr::<name>``, with nothing put in the store."""
    return span(name) if RECORDING else record_function("bsmr::" + name)


def count(name: str, value) -> None:
    """Record the counter ``name`` at ``value``; :func:`counters` gives the
    last value of each."""
    if hasattr(value, "item"):
        value = value.item()        # a NumPy scalar, as JSON takes it
    stack = _stack()
    _counts.append((name, value, time.perf_counter_ns(),
                    stack[-1].root if stack else None))


def watch_body(fn) -> None:
    """Let :func:`counters` read ``fn.forks`` while the body lives."""
    _bodies.add(fn)


def spans() -> List[Span]:
    """The closed host spans, oldest first (a child before its parent)."""
    return list(_host)


def counters() -> Dict[str, float]:
    """The last value of every recorded counter, and the counters that
    live elsewhere, read now: ``<op>.launches`` of the hand kernels
    (``bsr_dense.route.<route>`` besides, its launches by route),
    ``body.forks`` (summed over the bodies alive) and
    ``collectives.<name>``."""
    out = {name: value for name, value, _, _ in list(_counts)}
    dk = sys.modules.get("bsmr_sddmm_tpu_torch.ops.dense_kernels")
    if dk is not None:
        for fn in dk.WRAPPERS:
            out[f"{fn.__name__}.launches"] = fn.launches
            for route, n in getattr(fn, "routes", {}).items():
                out[f"{fn.__name__}.route.{route}"] = n
    bodies = list(_bodies)
    if bodies:
        out["body.forks"] = sum(fn.forks for fn in bodies)
    coll = sys.modules.get("bsmr_sddmm_tpu_torch.parallel.collectives")
    if coll is not None:
        out.update({f"collectives.{k}": v for k, v in coll.COUNTS.items()})
    return out


def clear() -> None:
    """Empty the store (spans, device records, counter records)."""
    with _lock:
        _host.clear()
        _device.clear()
        _counts.clear()
        _pending.clear()
        _captured.clear()


class record:
    """Turn the body's tier recording on or off: ``record(True)`` for the
    rest of the process, ``with record(True):`` for a block, after which
    it is as it was. Off, a body call tests one flag and records nothing."""

    def __init__(self, on: bool = True):
        global RECORDING
        self._was = RECORDING
        RECORDING = bool(on)

    def __enter__(self) -> "record":
        return self

    def __exit__(self, *exc) -> bool:
        global RECORDING
        RECORDING = self._was
        return False


# -- the body's tier spans ---------------------------------------------------

def _event(external: bool):
    global events_made
    if not external and _pool:
        return _pool.pop()
    events_made += 1
    return torch.cuda.Event(enable_timing=True, external=external)


class body_call:
    """The spans of one SDDMM body call while recording: the host span
    ``call`` and, for each tier, the host span ``body.<tier>`` (see
    :meth:`tier`). On a CUDA ``device`` each tier also records a timing
    event before and after it on the current stream, which is the side
    stream where the tier runs there."""

    __slots__ = ("device", "captured", "main", "tiers", "span")

    def __init__(self, device: Optional[torch.device]):
        self.device = device
        self.tiers: list = []
        if device is not None:
            self.captured = torch.cuda.is_current_stream_capturing()
            self.main = torch.cuda.current_stream(device)

    def __enter__(self) -> "body_call":
        self.span = _open("call")
        return self

    def __exit__(self, *exc) -> bool:
        _close(self.span)
        if self.tiers and exc[0] is None:
            if self.captured:
                _captured.append(self)
            else:
                if len(_pending) >= MAX_PENDING:
                    device_spans()
                _pending.append(self)
        return False

    @contextlib.contextmanager
    def tier(self, name: str) -> Iterator[None]:
        s = _open("body." + name)
        try:
            if self.device is None:
                yield
                return
            stream = torch.cuda.current_stream(self.device)
            start = _event(self.captured)
            start.record(stream)
            yield
            end = _event(self.captured)
            end.record(stream)
            self.tiers.append((s, "main" if stream == self.main else "side",
                               start, end))
        finally:
            _close(s)


def _anchor(device) -> tuple:
    """An event recorded on an idle ``device`` and the ``perf_counter_ns``
    right after its record was enqueued (the device reaches it within a
    few microseconds)."""
    torch.cuda.synchronize(device)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    t = time.perf_counter_ns()
    ev.synchronize()
    return ev, t


def _read(call: body_call, anchors: dict) -> List[dict]:
    """The device spans of one call: each tier's, and ``call`` from the
    first tier's start to the last's end. Every event is placed from the
    first one (short intervals, exact), which is placed from the anchor.
    A captured call whose graph never ran has no times: none."""
    if call.device not in anchors:
        anchors[call.device] = _anchor(call.device)
    anchor, t_anchor = anchors[call.device]
    first = call.tiers[0][2]
    try:
        t0 = t_anchor - round(first.elapsed_time(anchor) * 1e6)
        out = [dict(name=s.name, span=s.id, call=call.span.id,
                    root=call.span.root, stream=stream,
                    graph=call.captured,
                    start_ns=t0 + round(first.elapsed_time(a) * 1e6),
                    end_ns=t0 + round(first.elapsed_time(b) * 1e6))
               for s, stream, a, b in call.tiers]
    except (RuntimeError, ValueError):
        return []
    out.append(dict(name="call", span=call.span.id, call=call.span.id,
                    root=call.span.root, stream="main",
                    graph=call.captured, start_ns=out[0]["start_ns"],
                    end_ns=max(d["end_ns"] for d in out)))
    return out


def device_spans() -> List[dict]:
    """The device spans of the body calls recorded so far, on the host
    clock: each eager call's, read once (its events go back to the pool),
    and each captured call's last replay, read anew at every call. Each is
    a dict of ``name``, ``span`` (its host span's id), ``call``, ``root``,
    ``stream`` ("main" or "side"), ``graph`` (whether it was captured),
    ``start_ns`` and ``end_ns``. Synchronizes the devices it reads."""
    with _lock:
        anchors: dict = {}
        while _pending:
            call = _pending.popleft()
            _device.extend(_read(call, anchors))
            for _, _, a, b in call.tiers:
                _pool.extend((a, b))
        live = [d for call in list(_captured) for d in _read(call, anchors)]
        return list(_device) + live


# -- export ------------------------------------------------------------------

def snapshot(since_ns: int = 0) -> dict:
    """The store as plain data: host spans and device spans that start at
    or after ``since_ns``, the counters now and the counter records."""
    return dict(
        clock="time.perf_counter_ns",
        host=[s.as_dict() for s in spans() if s.start_ns >= since_ns],
        device=[d for d in device_spans() if d["start_ns"] >= since_ns],
        counters=counters(),
        counter_log=[dict(name=n, value=v, t_ns=t, root=r)
                     for n, v, t, r in list(_counts) if t >= since_ns])


def write(path: str, since_ns: int = 0) -> str:
    """Write :func:`snapshot` as JSON to ``path``; returns ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(snapshot(since_ns), f)
    return path


@contextlib.contextmanager
def phase_timer(sink: Dict[str, float], name: str) -> Iterator[None]:
    """Record the enclosed pipeline phase as the span ``name`` and add its
    milliseconds to ``sink[name]``, like the reference's per-phase
    CudaTimeCalculator fields."""
    s = _open(name)
    try:
        yield
    finally:
        _close(s)
        sink[name] = sink.get(name, 0.0) + s.duration_ms


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace (host, and the card where there
    is one) around the enclosed block, with the body's recording on; on
    exit the trace is written to ``<log_dir>/trace.json`` (open in
    chrome://tracing or Perfetto) and the block's spans and the counters to
    ``<log_dir>/spans.json``. Yields the trace's path."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    t0 = time.perf_counter_ns()
    with record(True), profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    write(os.path.join(log_dir, "spans.json"), since_ns=t0)


def _write_at_exit(log_dir: str) -> None:
    write(os.path.join(log_dir, "spans.json"))


if os.environ.get(TRACE_ENV):
    RECORDING = True
    atexit.register(_write_at_exit, os.environ[TRACE_ENV])
