"""Orchestration: reorder -> pack -> execute -> validate -> log.

The counterpart of ``bsmr_sddmm_tpu.sddmm`` (the CUDA original's sddmm()
driver, src/sddmm.cu:10-39): BSMR reorder, RPHM pack, the hybrid body,
optional validation against the fp64 oracle, with the row reordering cached
per alpha so a delta/K sweep reuses it.

The device is ``cuda`` when one is present; the CPU runs the kernels' plain
versions only when the caller asks for it, with ``device="cpu"`` or CPU
tensors. ``delta="auto"`` (and ``alpha="auto"``) picks the arm with
``autotune``; ``delta="dense"`` runs the dense fallback
(``baselines.make_bcoo_fn``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from bsmr_sddmm_tpu_torch.autotune import choose_config, choose_delta
from bsmr_sddmm_tpu_torch.baselines import make_bcoo_fn
from bsmr_sddmm_tpu_torch.cache import cached_row_reordering
from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.ops.sddmm import (device_plan, make_sddmm_body,
                                            resolve_device, sddmm_ref)
from bsmr_sddmm_tpu_torch.pack import TilePlan, pack_tiles
from bsmr_sddmm_tpu_torch.reorder import (BsmrReordering, row_reordering,
                                          split_columns)
from bsmr_sddmm_tpu_torch.utils.checkdata import check_data
from bsmr_sddmm_tpu_torch.utils.logger import RunLog
from bsmr_sddmm_tpu_torch.utils.profiling import span
from bsmr_sddmm_tpu_torch.utils.timing import (time_cuda, time_cuda_graph,
                                               time_host)


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class BsmrSddmm:
    """Reusable pipeline for one mask matrix.

    Caches the row reordering per alpha (the dominant preprocessing cost).
    ``device`` pins where the body runs; by default it is the device of
    tensor inputs, else ``cuda``.
    """

    def __init__(self, csr: CSR, config: Optional[SddmmConfig] = None,
                 device=None):
        self.csr = csr
        self.config = config or SddmmConfig()
        self.device = None if device is None else torch.device(device)
        self._row_cache: Dict[Tuple[float, str], BsmrReordering] = {}
        self._dense_fns: Dict[int, Callable] = {}

    def _device_for(self, A) -> torch.device:
        if self.device is not None:
            return self.device
        if isinstance(A, torch.Tensor):
            return A.device
        return resolve_device()

    def _operands(self, A, B, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """A (M, K) and Bt (N, K) as float32 tensors on ``device``; B may
        be (K, N) or pre-transposed (N, K)."""
        k = A.shape[1]
        A_t = torch.as_tensor(A).to(device=device, dtype=torch.float32)
        B_t = torch.as_tensor(B).to(device=device, dtype=torch.float32)
        Bt = B_t.T if B_t.shape[0] == k else B_t
        return A_t.contiguous(), Bt.contiguous()

    def _row_reordering(self, alpha: Optional[float] = None
                        ) -> BsmrReordering:
        cfg = self.config
        alpha = cfg.alpha if alpha is None else alpha
        key = (alpha, cfg.row_strategy)
        if key not in self._row_cache:
            reorder_rows = (cached_row_reordering if cfg.reorder_cache
                            else row_reordering)
            self._row_cache[key] = reorder_rows(
                self.csr, alpha, cfg.replace(alpha=alpha))
        return self._row_cache[key]

    def reorder(self, alpha: Optional[float] = None,
                delta: Optional[float] = None) -> BsmrReordering:
        cfg = self.config
        delta = cfg.delta if delta is None else delta
        base = self._row_reordering(alpha)
        # the column split is cheap; recompute it per delta on a copy
        return split_columns(self.csr, dataclasses.replace(base), cfg,
                             delta=delta)

    def choose(self, alpha=None, k: Optional[int] = None,
               refine_top: int = 0, device=None):
        """Full autotune decision: the best tiled plan across the delta
        candidates (autotune.DeltaChoice), or, with ``alpha="auto"``,
        across the whole (alpha, delta, subpack) grid
        (autotune.ConfigChoice, the CUDA original's test-mode sweep priced
        host-side); either may pick the dense fallback instead when the
        cost model says it wins. ``refine_top=N`` (else
        ``config.autotune_refine_top``) re-times the best-priced plans on
        ``device`` (default: the pipeline's device, else the CUDA card if
        there is one) and picks the measured argmin; on a CPU device the
        estimate order stands."""
        k = k or self.config.k
        if alpha == "auto":
            if device is None:
                device = self.device or (torch.device("cuda")
                                         if torch.cuda.is_available()
                                         else None)
            return choose_config(self.csr, self._row_reordering,
                                 self.config, k=k,
                                 refine_top=(refine_top or
                                             self.config.autotune_refine_top),
                                 device=device)
        return choose_delta(self.csr, self._row_reordering(alpha),
                            self.config, k=k)

    def plan(self, alpha: Optional[float] = None,
             delta=None, k: Optional[int] = None) -> TilePlan:
        """Pack a plan. ``delta="auto"`` picks the delta with the lowest
        predicted time (``choose``). Recorded as the span ``prep.plan``,
        the root of the row clustering's, column split's and packing's
        spans."""
        if delta == "auto":
            return self.choose(alpha, k=k).plan
        if alpha == "auto":
            raise ValueError('alpha="auto" requires delta="auto"')
        with span("prep.plan"):
            reord = self.reorder(alpha, delta)
            return pack_tiles(self.csr, reord, self.config,
                              k=k or self.config.k)

    def dense_fn(self, k: int) -> Callable:
        """The dense-fallback executor ``fn(A, Bt) -> P`` (CSR order): the
        stock sparse SDDMM ``torch.sparse.sampled_addmm`` (cuSPARSE on the
        card), where the JAX package takes its sampled dense dot
        (bcoo_dot_general_sampled). ``autotune.estimate_dense_ms`` prices
        it."""
        if k not in self._dense_fns:
            self._dense_fns[k] = make_bcoo_fn(self.csr, k)
        return self._dense_fns[k]

    def _auto(self, alpha, delta, k: int, device):
        """Resolve ``delta="auto"`` with one autotune pass: (alpha, delta,
        plan), where delta is "dense" if the fallback won, and plan is the
        chosen tiled plan (else None)."""
        if delta != "auto":
            if alpha == "auto":
                raise ValueError('alpha="auto" requires delta="auto"')
            return alpha, delta, None
        choice = self.choose(alpha, k=k, device=device)
        if alpha == "auto":
            alpha = choice.alpha
        if choice.use_dense:
            return alpha, "dense", None
        return alpha, choice.plan.delta_used, choice.plan

    def compile(self, plan: TilePlan, backend: Optional[str] = None,
                emit: str = "csr"):
        """The body for ``plan`` (PyTorch runs eagerly; the kernels build
        once per process, at their first launch)."""
        return make_sddmm_body(plan, self.config, backend, emit=emit)

    def run(self, A, B, alpha: Optional[float] = None,
            delta: Optional[float] = None,
            backend: Optional[str] = None) -> np.ndarray:
        """One-shot execution; returns P (nnz,) in CSR value order.

        ``delta="auto"`` autotunes over tiled plans and the dense fallback;
        ``delta="dense"`` forces the fallback (no preprocessing)."""
        device = self._device_for(A)
        A_t, Bt_t = self._operands(A, B, device)
        k = A_t.shape[1]
        alpha, delta, plan = self._auto(alpha, delta, k, device)
        if delta == "dense":
            return _host(self.dense_fn(k)(A_t, Bt_t))
        if plan is None:
            plan = self.plan(alpha, delta, k=k)
        out = self.compile(plan, backend)(A_t, Bt_t,
                                          device_plan(plan, device))
        return _host(out)

    def benchmark(self, A, B, alpha: Optional[float] = None,
                  delta: Optional[float] = None,
                  backend: Optional[str] = None,
                  validate: bool = False,
                  tier_times: bool = False,
                  time_csr_emit: bool = True,
                  file: str = "") -> RunLog:
        """Timed run producing a reference-schema RunLog: the headline
        ``sddmm_ms`` is the rphm body (every nonzero computed once, no
        reorder), ``sddmm_csr_ms`` the CSR-order emission. ``tier_times``
        adds each tier's time alone (``tier_*_ms``) and their sum over the
        headline (``tier_overlap_efficiency``). ``delta="auto"`` logs the
        chosen alpha and delta (and, as the JAX package does, the base row
        reordering's clusters and times); a dense-fallback run logs
        ``delta=nan`` and ``strategy=dense_fallback``.

        On a CUDA device each time of the tiled body is a replayed CUDA
        graph of one call (``time_cuda_graph``): one host launch per call,
        the card's form of the JAX package's in-program repetition, which
        leaves submission out. The rphm body's time over eager calls, host
        enqueue included, goes into ``extras["sddmm_eager_ms"]``. The dense
        fallback is timed the same two ways."""
        cfg = self.config
        device = self._device_for(A)
        A_t, Bt_t = self._operands(A, B, device)
        k = A_t.shape[1]
        timer = time_cuda_graph if device.type == "cuda" else time_host
        alpha, delta, plan = self._auto(alpha, delta, k, device)
        if delta == "dense":
            return self._benchmark_dense(A, B, A_t, Bt_t, alpha=alpha,
                                         validate=validate, file=file)
        if plan is None:
            with span("prep.plan"):
                reord = self.reorder(alpha, delta)
                plan = pack_tiles(self.csr, reord, cfg, k=k)
        else:
            reord = self._row_reordering(alpha)
        dplan = device_plan(plan, device, emit="rphm")
        body = self.compile(plan, backend, emit="rphm")
        ms, _ = timer(body, A_t, Bt_t, dplan, iterations=cfg.num_iterations)
        eager_ms = (time_cuda(body, A_t, Bt_t, dplan,
                              iterations=cfg.num_iterations)[0]
                    if device.type == "cuda" else ms)
        ms_csr, out = 0.0, None
        if time_csr_emit or validate:
            fn = self.compile(plan, backend, emit="csr")
            dplan_full = device_plan(plan, device)
            if time_csr_emit:
                ms_csr, out = timer(fn, A_t, Bt_t, dplan_full,
                                    iterations=cfg.num_iterations)
            else:
                out = fn(A_t, Bt_t, dplan_full)
        log = RunLog(
            file=file,
            device=_device_name(device),
            backend=backend or cfg.backend,
            m=self.csr.rows, n=self.csr.cols, k=k, nnz=self.csr.nnz,
            sparsity=self.csr.sparsity,
            alpha=cfg.alpha if alpha is None else alpha,
            delta=cfg.delta if delta is None else delta,
            panel_height=cfg.panel_height, block_width=cfg.block_width,
            num_clusters=reord.num_clusters,
            num_row_panels=plan.num_panels,
            num_dense_blocks=plan.num_tiles,
            num_packed_blocks=plan.num_packed,
            num_gathered_blocks=plan.num_gathered,
            dense_nnz=plan.dense_nnz,
            packed_nnz=plan.packed_nnz,
            gathered_nnz=plan.gathered_nnz,
            residual_nnz=plan.residual_nnz,
            average_tile_density=plan.average_tile_density,
            row_reordering_ms=reord.row_time_ms,
            col_reordering_ms=reord.col_time_ms,
            pack_ms=plan.pack_time_ms,
            sddmm_ms=ms,
        )
        log.extras["sddmm_eager_ms"] = f"{eager_ms:.6f}"
        log.extras["sddmm_csr_ms"] = f"{ms_csr:.6f}"
        log.extras["gflops_csr"] = (
            f"{2.0 * self.csr.nnz * k / (ms_csr * 1e6):.3f}"
            if ms_csr > 0 else "0")
        log.extras["fat_group"] = plan.fat_group
        if tier_times:
            # each tier timed alone (the CUDA original's dense/sparse
            # overlap measurement, src/sddmmKernel.cu:2834-2844); the tiers
            # run back to back in one call, so the sum shows where the
            # headline time goes
            tiers = ["dense", "gathered", "residual"]
            if plan.num_packed:
                tiers.insert(1, "packed")
            tier_ms = {}
            for tier in tiers:
                tfn = make_sddmm_body(plan, cfg, backend, only_tier=tier)
                tier_ms[tier], _ = timer(tfn, A_t, Bt_t, dplan,
                                         iterations=cfg.num_iterations)
                log.extras[f"tier_{tier}_ms"] = f"{tier_ms[tier]:.6f}"
            overlap = sum(tier_ms.values()) / ms if ms > 0 else 0.0
            log.extras["tier_overlap_efficiency"] = f"{overlap:.3f}"
        if validate:
            self._validate(log, A, B, out)
        return log

    def _benchmark_dense(self, A, B, A_t, Bt_t,
                         alpha: Optional[float] = None,
                         validate: bool = False, file: str = "") -> RunLog:
        """Timed dense-fallback run: no reordering, no packing; on a CUDA
        device a replayed graph of one call, as the tiled headline."""
        cfg = self.config
        k = A_t.shape[1]
        fn = self.dense_fn(k)
        if A_t.is_cuda:
            ms, out = time_cuda_graph(fn, A_t, Bt_t,
                                      iterations=cfg.num_iterations)
            eager_ms = time_cuda(fn, A_t, Bt_t,
                                 iterations=cfg.num_iterations)[0]
        else:
            ms, out = time_host(fn, A_t, Bt_t, iterations=cfg.num_iterations)
            eager_ms = ms
        log = RunLog(
            file=file,
            device=_device_name(A_t.device),
            backend=cfg.backend,
            m=self.csr.rows, n=self.csr.cols, k=k, nnz=self.csr.nnz,
            sparsity=self.csr.sparsity,
            alpha=cfg.alpha if alpha is None else alpha,
            delta=float("nan"),
            panel_height=cfg.panel_height, block_width=cfg.block_width,
            sddmm_ms=ms,
        )
        log.extras["strategy"] = "dense_fallback"
        log.extras["sddmm_eager_ms"] = f"{eager_ms:.6f}"
        if validate:
            self._validate(log, A, B, out)
        return log

    def _validate(self, log: RunLog, A, B, out) -> None:
        """Hold ``out`` against the fp64 oracle (check_data tolerance)."""
        A_np, B_np = _host(A), _host(B)
        B_np = B_np if B_np.shape[0] == A_np.shape[1] else B_np.T
        res = check_data(sddmm_ref(A_np, B_np, self.csr), _host(out))
        log.check_result = "pass" if res.passed else "fail"
        log.error_rate = res.error_rate


def sddmm(A, B, csr: CSR, config: Optional[SddmmConfig] = None,
          device=None) -> np.ndarray:
    """Functional one-shot entry point (CUDA original sddmm(),
    src/sddmm.cu:10-39). A is (M, K); B is (K, N) or pre-transposed
    (N, K); returns P values aligned with csr.values order."""
    return BsmrSddmm(csr, config, device=device).run(A, B)
