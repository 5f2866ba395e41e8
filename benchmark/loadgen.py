"""The general traffic generator and one run of one cell.

A traffic mix is a closed loop of back-to-back SDDMM calls on one mask,
described by its JSON file:

- ``k``: the operands' inner dimension;
- ``mode``: ``"replay"``, each call a replay of a CUDA graph captured from
  one call on its operand pair (one graph per pair), or
  ``"eager"``, each call ``fn(A, Bt, dplan)`` from Python;
- ``ring_min_bytes``: the ring of operand pairs holds the fewest pairs whose
  A and B together reach this many bytes, so that no call finds its
  operands in the card's L2 cache; call ``i`` reads pair ``i % pairs``;
- ``warmup_calls``: calls in set-up, after every graph is captured;
- ``trace_calls``: calls under the profiler in a ``--trace 1`` run.

Set-up preprocesses the mask ``PREP_REPEATS`` times, each time on a new
pipeline, and times each (``prep_s`` reads the fastest): one
preprocessing spreads by a fifth between runs with the host's speed.

The program is driven through its public entry:
``BsmrSddmm(csr, cfg).plan(alpha, delta, k)``, ``ops.sddmm.device_plan``,
``BsmrSddmm.compile(plan, emit="csr")``; a call returns the (nnz,) values in
CSR order. The mask, the operands and the reference's inputs are the
benchmark's own (``data.generators``, ``make_ring``).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from benchmark import reference, spec, tracing
from benchmark.data.generators import Mask, cached_mask

#: preprocessings of the mask in set-up, each timed
PREP_REPEATS = 5


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_ring(m: int, n: int, k: int, ring_min_bytes: int, seed: int,
              device: torch.device) -> List[tuple]:
    """Operand pairs ``(A (m, k), Bt (n, k))``, uniform [0, 2) fp32 (the
    original's ``makeData`` convention), drawn on ``device`` from ``seed``
    in two calls."""
    pairs = max(1, math.ceil(ring_min_bytes / (4 * (m + n) * k)))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & 0xFFFF_FFFF_FFFF_FFFF)
    A = torch.rand((pairs, m, k), generator=gen, device=device).mul_(2.0)
    Bt = torch.rand((pairs, n, k), generator=gen, device=device).mul_(2.0)
    return [(A[i], Bt[i]) for i in range(pairs)]


class EagerCaller:
    """Each call runs the body from Python; the last output of each pair
    is kept for the check."""

    def __init__(self, fn, ring, dplan):
        self.fn, self.ring, self.dplan = fn, ring, dplan
        self.outs = [None] * len(ring)

    def __call__(self, i: int) -> None:
        A, Bt = self.ring[i]
        self.outs[i] = self.fn(A, Bt, self.dplan)


class ReplayCaller:
    """One CUDA graph per pair, captured from one call of the body; each
    call replays the pair's graph, which rewrites that graph's output.

    Each graph has a memory pool of its own. In a shared pool a graph
    captured later may hold its output where an earlier graph keeps its
    scratch, so replaying the earlier graph overwrites that output, and a
    window that ends inside a round of the ring leaves some pairs' outputs
    overwritten."""

    def __init__(self, fn, ring, dplan, device: torch.device):
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn(*ring[0], dplan)         # allocator and library warm-up
        cur.wait_stream(side)
        self.graphs, self.outs = [], []
        for A, Bt in ring:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn(A, Bt, dplan)
            self.graphs.append(graph)
            self.outs.append(out)

    def __call__(self, i: int) -> None:
        self.graphs[i].replay()


@dataclasses.dataclass
class Run:
    """What one run read; the metric readers take their numbers from it."""

    device_name: str
    mode: str
    m: int
    n: int
    nnz: int
    k: int
    pairs: int
    setup_s: float = 0.0
    # one entry per preprocessing of set-up
    prep_s: List[float] = dataclasses.field(default_factory=list)
    prep_reorder_ms: List[float] = dataclasses.field(default_factory=list)
    prep_pack_ms: List[float] = dataclasses.field(default_factory=list)
    calls: int = 0                  # calls in the measured window
    window_s: float = 0.0
    spans_ms: Optional[np.ndarray] = None
    traced: Optional[dict] = None   # see Cell.trace
    memory_peak_bytes: int = 0
    attempted: int = 0
    counters: dict = dataclasses.field(default_factory=dict)
    setup_parts: dict = dataclasses.field(default_factory=dict)  # seconds
    max_rel_err: Optional[float] = None
    pair_errs: List[float] = dataclasses.field(default_factory=list)


class Cell:
    """One configuration under one traffic mix, set up on ``device``.

    ``settings`` overrides entries of the configuration's ``settings``
    (the control runs the program at ``matmul_precision="default"``);
    ``root`` is the checkout whose generator files make the mask."""

    def __init__(self, config: dict, traffic: dict, device,
                 settings: Optional[dict] = None, root: str = spec.ROOT):
        self.config, self.traffic, self.root = config, traffic, root
        self.device = torch.device(device)
        self.k = int(traffic["k"])
        self.mode = traffic["mode"]
        if self.mode not in ("replay", "eager"):
            raise ValueError(f"unknown traffic mode {self.mode!r}")
        self.settings = dict(config["settings"], **(settings or {}))
        self.arm = config["arms"][str(self.k)]

    # -- set-up -------------------------------------------------------------
    def prepare(self, run_dir: str) -> Run:
        """Mask, preprocessing (each of ``PREP_REPEATS`` timed: ``prep_s``)
        and the body, on the last preprocessing's plan."""
        t_init = time.perf_counter()
        from bsmr_sddmm_tpu_torch import BsmrSddmm, CSR, SddmmConfig, native
        from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan
        from bsmr_sddmm_tpu_torch.utils.compilecache import \
            enable_compile_cache
        from bsmr_sddmm_tpu_torch.utils.hostmem import tune_malloc
        os.environ["BSMR_NATIVE_CACHE"] = os.path.join(run_dir, "native")
        os.environ["BSMR_CACHE_DIR"] = os.path.join(
            tempfile.gettempdir(), "bsmr_reorder_cache")
        if self.device.type == "cuda":
            enable_compile_cache(os.path.join(run_dir, "torch_kernels"))
            # the CUDA context, made once a process, is not preprocessing
            torch.empty(1, device=self.device)
            _sync(self.device)
        tune_malloc()
        native.available()   # the clustering library: built once, not prep
        t_mask = time.perf_counter()
        t_init = t_mask - t_init
        self.mask: Mask = cached_mask(self.config["mask"],
                                      os.path.join(run_dir, "masks"),
                                      self.root)
        t_mask = time.perf_counter() - t_mask
        mask = self.mask
        if self.config.get("expected_nnz") not in (None, mask.nnz):
            raise RuntimeError(f"the mask has {mask.nnz} nonzeros, the "
                               f"configuration {self.config['expected_nnz']}")
        csr = CSR(mask.rows, mask.cols, mask.row_offsets, mask.col_indices,
                  np.ones(mask.nnz, np.float32))
        cfg = SddmmConfig(k=self.k, **self.settings, **self.arm)
        self.cfg = cfg
        run = Run(device_name=_device_name(self.device), mode=self.mode,
                  m=mask.rows, n=mask.cols, nnz=mask.nnz, k=self.k,
                  pairs=0)
        t_prep = time.perf_counter()
        for _ in range(PREP_REPEATS):
            self.pipeline = self.plan = self.dplan = None
            self.pipeline = BsmrSddmm(csr, cfg, device=self.device)
            t0 = time.perf_counter()
            self.plan = self.pipeline.plan(cfg.alpha, cfg.delta, self.k)
            self.dplan = device_plan(self.plan, self.device)
            _sync(self.device)
            run.prep_s.append(time.perf_counter() - t0)
            # the plan's row clustering is cached by its pipeline; the
            # column split is recomputed, outside the timed span
            reord = self.pipeline.reorder(cfg.alpha, cfg.delta)
            run.prep_reorder_ms.append(reord.row_time_ms + reord.col_time_ms)
            run.prep_pack_ms.append(self.plan.pack_time_ms)
        t_prep = time.perf_counter() - t_prep
        self.fn = self.pipeline.compile(self.plan, emit="csr")
        run.setup_parts = {"init": t_init, "mask": t_mask, "prep": t_prep}
        return run

    def load(self, run: Run, seed: int) -> None:
        """The operand ring from ``seed``, the callers, and the warm-up."""
        t0 = time.perf_counter()
        self.ring = make_ring(run.m, run.n, self.k,
                              int(self.traffic["ring_min_bytes"]), seed,
                              self.device)
        run.pairs = len(self.ring)
        _sync(self.device)
        t1 = time.perf_counter()
        if self.mode == "replay":
            self.caller = ReplayCaller(self.fn, self.ring, self.dplan,
                                       self.device)
        else:
            self.caller = EagerCaller(self.fn, self.ring, self.dplan)
        t2 = time.perf_counter()
        for i in range(int(self.traffic["warmup_calls"])):
            self.caller(i % run.pairs)
        _sync(self.device)
        run.setup_parts.update(ring=t1 - t0, callers=t2 - t1,
                               warmup=time.perf_counter() - t2)

    # -- measurement --------------------------------------------------------
    def window(self, run: Run, seconds: float) -> None:
        """Back-to-back calls for ``seconds``; each call's span between
        events recorded on the calling stream right before and after it.
        The window ends at a synchronize after the last call."""
        pairs, caller = run.pairs, self.caller
        cuda = self.device.type == "cuda"
        marks = []
        _sync(self.device)
        gc.collect()
        gc.disable()        # no collection pauses the host inside the window
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        if cuda:
            event = torch.cuda.Event
            while time.perf_counter() < deadline:
                start = event(enable_timing=True)
                end = event(enable_timing=True)
                start.record()
                caller(i % pairs)
                end.record()
                marks.append((start, end))
                i += 1
        else:
            while True:
                t = time.perf_counter()
                if t >= deadline:
                    break
                caller(i % pairs)
                marks.append((t, time.perf_counter()))
                i += 1
        _sync(self.device)
        run.window_s = time.perf_counter() - t0
        gc.enable()
        run.calls = i
        run.attempted += i
        run.spans_ms = np.array(
            [s.elapsed_time(e) if cuda else (e - s) * 1e3
             for s, e in marks])

    def trace(self, run: Run, calls: int) -> None:
        """``calls`` calls under ``torch.profiler``: ``run.traced`` holds
        the device activities (CUPTI records the kernels a graph replay
        launches too), the traced window's seconds, the calls and the
        breakdown."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        _sync(self.device)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for i in range(calls):
                self.caller(i % run.pairs)
            _sync(self.device)
            window_s = time.perf_counter() - t0
        run.attempted += calls
        import bsmr_sddmm_tpu_torch
        kernels = tracing.kernels(prof)
        ops = tracing.host_ops(prof)
        run.traced = dict(
            kernels=kernels, calls=calls, window_s=window_s,
            hand=tracing.hand_kernel_names(
                os.path.dirname(bsmr_sddmm_tpu_torch.__file__)),
            busy_s=tracing.union_us(kernels) / 1e6,
            device_ops=tracing.top(tracing.time_by_name(kernels)),
            idle_gaps=tracing.top(tracing.idle_gaps(kernels, ops)))

    def counters(self, run: Run) -> None:
        """The program's own counters: the launches of every counting
        wrapper of its hand kernels, and the body's forks."""
        from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
        run.counters = {f"{fn.__name__}.launches": fn.launches
                        for fn in dk.WRAPPERS}
        run.counters["body.forks"] = self.fn.forks

    # -- the check ----------------------------------------------------------
    def check(self, run: Run, keep_body: bool = False) -> None:
        """Every pair's last output against the reference, once the peak
        memory is read and the program's state (the callers' graphs and
        outputs, and unless ``keep_body`` the body and its plan) is
        freed."""
        if self.device.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(
                self.device)
        outs = [None if out is None else out.clone()
                for out in self.caller.outs]
        ring, self.ring, self.caller = self.ring, None, None
        if not keep_body:
            self.fn = self.dplan = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        rows = torch.from_numpy(self.mask.coo_rows()).to(self.device)
        cols = torch.from_numpy(
            self.mask.col_indices.astype(np.int64)).to(self.device)
        run.pair_errs = [
            float("inf") if out is None else
            reference.max_rel_err(out, A, Bt, rows, cols)
            for out, (A, Bt) in zip(outs, ring)]
        run.max_rel_err = max(run.pair_errs)


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
