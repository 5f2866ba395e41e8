"""Orchestration: reorder -> pack -> execute -> validate -> log.

The counterpart of ``bsmr_sddmm_tpu.sddmm`` (the CUDA original's sddmm()
driver, src/sddmm.cu:10-39): BSMR reorder, RPHM pack, the hybrid body,
optional validation against the fp64 oracle, with the row reordering cached
per alpha so a delta/K sweep reuses it.

The device is ``cuda`` when one is present; the CPU runs the kernels' plain
versions only when the caller asks for it, with ``device="cpu"`` or CPU
tensors. Autotune (``alpha``/``delta="auto"``), the dense fallback
(``delta="dense"``), ``tier_times`` and the reorder cache are not ported
yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.ops.sddmm import (device_plan, make_sddmm_body,
                                            sddmm_ref)
from bsmr_sddmm_tpu_torch.pack import TilePlan, pack_tiles
from bsmr_sddmm_tpu_torch.reorder import (BsmrReordering, row_reordering,
                                          split_columns)
from bsmr_sddmm_tpu_torch.utils.checkdata import check_data
from bsmr_sddmm_tpu_torch.utils.logger import RunLog
from bsmr_sddmm_tpu_torch.utils.timing import time_cuda, time_host


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet; see ROADMAP.md")


def _check_ported(alpha, delta) -> None:
    if alpha == "auto" or delta == "auto":
        raise _not_ported('autotune (alpha="auto" / delta="auto")')
    if delta == "dense":
        raise _not_ported('the dense fallback (delta="dense")')


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

    def _device_for(self, A) -> torch.device:
        if self.device is not None:
            return self.device
        if isinstance(A, torch.Tensor):
            return A.device
        if torch.cuda.is_available():
            return torch.device("cuda")
        raise RuntimeError(
            "no CUDA device: pass device='cpu' (or CPU tensors) to run the "
            "kernels' plain versions on the CPU")

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
        if cfg.reorder_cache:
            raise _not_ported("the on-disk reorder cache (reorder_cache)")
        alpha = cfg.alpha if alpha is None else alpha
        key = (alpha, cfg.row_strategy)
        if key not in self._row_cache:
            self._row_cache[key] = row_reordering(
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

    def plan(self, alpha: Optional[float] = None,
             delta=None, k: Optional[int] = None) -> TilePlan:
        _check_ported(alpha, delta)
        reord = self.reorder(alpha, delta)
        return pack_tiles(self.csr, reord, self.config,
                          k=k or self.config.k)

    def compile(self, plan: TilePlan, backend: Optional[str] = None,
                emit: str = "csr"):
        """The body for ``plan`` (PyTorch runs eagerly; the kernels build
        once per process, at their first launch)."""
        return make_sddmm_body(plan, self.config, backend, emit=emit)

    def run(self, A, B, alpha: Optional[float] = None,
            delta: Optional[float] = None,
            backend: Optional[str] = None) -> np.ndarray:
        """One-shot execution; returns P (nnz,) in CSR value order."""
        _check_ported(alpha, delta)
        device = self._device_for(A)
        A_t, Bt_t = self._operands(A, B, device)
        plan = self.plan(alpha, delta, k=A_t.shape[1])
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
        reorder), ``sddmm_csr_ms`` the CSR-order emission."""
        _check_ported(alpha, delta)
        if tier_times:
            raise _not_ported("the per-tier time split (tier_times)")
        cfg = self.config
        device = self._device_for(A)
        A_t, Bt_t = self._operands(A, B, device)
        k = A_t.shape[1]
        reord = self.reorder(alpha, delta)
        plan = pack_tiles(self.csr, reord, cfg, k=k)
        timer = time_cuda if device.type == "cuda" else time_host
        ms, _ = timer(self.compile(plan, backend, emit="rphm"), A_t, Bt_t,
                      device_plan(plan, device, emit="rphm"),
                      iterations=cfg.num_iterations)
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
            device=(torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
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
        log.extras["sddmm_csr_ms"] = f"{ms_csr:.6f}"
        log.extras["gflops_csr"] = (
            f"{2.0 * self.csr.nnz * k / (ms_csr * 1e6):.3f}"
            if ms_csr > 0 else "0")
        log.extras["fat_group"] = plan.fat_group
        if validate:
            B_np = _host(B)
            B_np = B_np if B_np.shape[0] == k else B_np.T
            expected = sddmm_ref(_host(A), B_np, self.csr)
            res = check_data(expected, _host(out))
            log.check_result = "pass" if res.passed else "fail"
            log.error_rate = res.error_rate
        return log


def sddmm(A, B, csr: CSR, config: Optional[SddmmConfig] = None,
          device=None) -> np.ndarray:
    """Functional one-shot entry point (CUDA original sddmm(),
    src/sddmm.cu:10-39). A is (M, K); B is (K, N) or pre-transposed
    (N, K); returns P values aligned with csr.values order."""
    return BsmrSddmm(csr, config, device=device).run(A, B)
