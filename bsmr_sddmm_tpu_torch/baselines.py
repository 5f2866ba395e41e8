"""Baseline SDDMM implementations for the comparison methodology.

The counterpart of ``bsmr_sddmm_tpu.baselines``. The CUDA original
benchmarks BSMR against eight CUDA baselines (cuSPARSE, cuSDDMM, ASpT, RoDe,
Sputnik, TCGNN, FlashSparse, BSA) with a shared log schema; the JAX package
and this one provide the comparable baselines of their own framework:

* ``dense_masked`` — the full ``A @ B`` in row blocks through
  ``torch.matmul``, then one gather at the mask. The "just use the dense
  library" ceiling: it wastes ``1/density`` of the flops.
* ``bcoo`` — the framework's stock sparse SDDMM, here
  ``torch.sparse.sampled_addmm`` (cuSPARSE SDDMM on the card, like
  cusparseSDDMM in the original's baselines/cuSPARSE_SDDMM). The name is the
  JAX package's (``bcoo_dot_general_sampled``), so that logs line up.
* ``gather_dot`` — per-nonzero row gathers of A and B^T with a
  multiply-sum, chunked: the framework's own residual tier applied to all
  nonzeros (the delta = 1.1 ablation).

Every baseline is ``fn(A, Bt) -> P`` with P (nnz,) in CSR value order on the
device of A; index tensors are uploaded once per device. These are library
and plain torch paths: no hand kernel stands behind them.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict

import numpy as np
import torch

from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.ops.sddmm import sddmm_ref
from bsmr_sddmm_tpu_torch.utils.checkdata import check_data
from bsmr_sddmm_tpu_torch.utils.logger import RunLog
from bsmr_sddmm_tpu_torch.utils.timing import time_cuda, time_host

BASELINE_NAMES = ("dense_masked", "bcoo", "gather_dot")


def _per_device(build: Callable[[torch.device], object]):
    """``get(device)``: ``build(device)`` once per device, then cached."""
    cache: Dict[torch.device, object] = {}

    def get(device: torch.device):
        if device not in cache:
            cache[device] = build(device)
        return cache[device]
    return get


def make_dense_masked_fn(csr: CSR, k: int, tile_m: int = 512) -> Callable:
    """Full-matmul baseline: P = (A @ B)[rows, cols].

    The product runs in row blocks of ``tile_m``, so the live intermediate
    is ``tile_m * N`` floats rather than ``M * N``; each block's nonzeros
    are one contiguous CSR range, gathered from the block's product. The
    matmul is fp32 (TF32 only if the caller enabled it in torch.backends)."""
    offsets = csr.row_offsets
    local = (csr.coo_rows().astype(np.int64) * csr.cols
             + csr.col_indices.astype(np.int64))

    def build(device):
        blocks = []
        for s in range(0, csr.rows, tile_m):
            e = min(s + tile_m, csr.rows)
            lo, hi = int(offsets[s]), int(offsets[e])
            if hi > lo:
                idx = torch.from_numpy(local[lo:hi] - s * csr.cols)
                blocks.append((s, e, idx.to(device)))
        return blocks

    blocks_on = _per_device(build)

    def fn(A: torch.Tensor, Bt: torch.Tensor) -> torch.Tensor:
        A, B = A.to(torch.float32), Bt.to(torch.float32).T
        parts = [torch.matmul(A[s:e], B).reshape(-1).index_select(0, idx)
                 for s, e, idx in blocks_on(A.device)]
        return torch.cat(parts) if parts else A.new_zeros(0)

    return fn


def make_bcoo_fn(csr: CSR, k: int) -> Callable:
    """Stock sparse SDDMM: ``torch.sparse.sampled_addmm(S, A, B, beta=0)``,
    whose values come back in S's CSR order."""

    def build(device):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*Sparse CSR tensor "
                                    "support is in beta")
            warnings.filterwarnings("ignore", message=".*Sparse invariant "
                                    "checks are implicitly disabled")
            return torch.sparse_csr_tensor(
                torch.from_numpy(csr.row_offsets.astype(np.int64)),
                torch.from_numpy(csr.col_indices.astype(np.int64)),
                torch.ones(csr.nnz), size=(csr.rows, csr.cols),
                check_invariants=False).to(device)

    mask_on = _per_device(build)

    def fn(A: torch.Tensor, Bt: torch.Tensor) -> torch.Tensor:
        S = mask_on(A.device)
        return torch.sparse.sampled_addmm(
            S, A.to(torch.float32), Bt.to(torch.float32).T,
            beta=0.0).values()

    return fn


def make_gather_dot_fn(csr: CSR, k: int, chunk: int = 1 << 16) -> Callable:
    """Per-nonzero gather + multiply-sum, ``chunk`` nonzeros at a time."""
    rows = torch.from_numpy(csr.coo_rows().astype(np.int32))
    cols = torch.from_numpy(csr.col_indices.astype(np.int32))
    index_on = _per_device(lambda d: (rows.to(d), cols.to(d)))

    def fn(A: torch.Tensor, Bt: torch.Tensor) -> torch.Tensor:
        A, Bt = A.to(torch.float32), Bt.to(torch.float32)
        r, c = index_on(A.device)
        parts = [(A.index_select(0, r[s:s + chunk])
                  * Bt.index_select(0, c[s:s + chunk])).sum(-1)
                 for s in range(0, csr.nnz, chunk)]
        return torch.cat(parts) if parts else A.new_zeros(0)

    return fn


_FACTORIES = {
    "dense_masked": make_dense_masked_fn,
    "bcoo": make_bcoo_fn,
    "gather_dot": make_gather_dot_fn,
}


def make_baseline_fn(name: str, csr: CSR, k: int, **kw) -> Callable:
    if name not in _FACTORIES:
        raise ValueError(f"unknown baseline {name!r}; "
                         f"choose from {BASELINE_NAMES}")
    return _FACTORIES[name](csr, k, **kw)


def benchmark_baseline(name: str, csr: CSR, A, B, iterations: int = 10,
                       file: str = "", validate: bool = False,
                       device=None) -> RunLog:
    """Timed baseline run with the shared RunLog schema (the original's
    baseline drivers emit the same [key : value] records its analyzer
    parses, scripts/test_FlashSparse.py:208-213). ``device`` defaults to the
    device of a tensor ``A``, else ``cuda``; CUDA events time it on the
    card, the host clock on the CPU. B is (K, N) or pre-transposed (N, K)."""
    if device is None:
        device = A.device if isinstance(A, torch.Tensor) else "cuda"
    device = torch.device(device)
    A_t = torch.as_tensor(A).to(device=device, dtype=torch.float32)
    B_t = torch.as_tensor(B).to(device=device, dtype=torch.float32)
    k = A_t.shape[1]
    Bt = (B_t.T if B_t.shape[0] == k else B_t).contiguous()
    fn = make_baseline_fn(name, csr, k)
    timer = time_cuda if device.type == "cuda" else time_host
    ms, out = timer(fn, A_t.contiguous(), Bt, iterations=iterations)
    log = RunLog(
        file=file,
        device=(torch.cuda.get_device_name(device)
                if device.type == "cuda" else device.type),
        backend=name,
        m=csr.rows, n=csr.cols, k=k, nnz=csr.nnz,
        sparsity=csr.sparsity,
        sddmm_ms=ms,
    )
    if validate:
        A_np = A_t.cpu().numpy()
        expected = sddmm_ref(A_np, Bt.T.cpu().numpy(), csr)
        res = check_data(expected, out.cpu().numpy())
        log.check_result = "pass" if res.passed else "fail"
        log.error_rate = res.error_rate
    return log
