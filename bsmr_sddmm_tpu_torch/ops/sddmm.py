"""Hybrid SDDMM body on PyTorch: two hand-kernel tile tiers, a gathered
tile tier and a per-nonzero residual.

The counterpart of ``bsmr_sddmm_tpu.ops.sddmm`` (``device_plan``,
``make_sddmm_body``, ``sddmm_ref``). Given A (M, K) and Bt = B^T (N, K):

1. ``A_perm = A[row_perm_padded]``, viewed as panels (P, ph, K);
2. dense tier: ``dense_kernels.bsr_dense`` over natural column blocks;
3. packed tier: ``Bt2 = Bt[sp_colperm]`` once, then ``dense_kernels.subpack``;
4. gathered tier: a row gather of each tile's bw columns and one ``bmm``;
5. residual: two row gathers and a multiply-sum per nonzero.

The output is the four tiers' arrays (``emit="rphm"``) or one gather of
their concatenation along ``rphm_to_csr`` (``emit="csr"``, CSR value order).
Tiers 4 and 5 are plain torch (the JAX package leaves them to XLA too). The
JAX body's gather windows (``g_groups``, ``res_groups``) avoid a gather-rate
cliff of its TPU; here those plans run by absolute index, which gives the
same values. Padded tail slots are computed from valid pad indices; no slot
past a tier's real count is ever read by ``rphm_to_csr``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.pack import TilePlan


class DevicePlan(NamedTuple):
    """A TilePlan's index arrays as int32 tensors on one device.
    ``tile_src`` holds one column block per fat step (``step_cblock``), or
    one per tile (``tile_cblock``) when the plan's fat group is 1."""

    row_perm_padded: torch.Tensor   # (num_panels*ph,)
    tile_panel: torch.Tensor        # (T,)
    tile_src: torch.Tensor          # (T // G,)
    tile_scatter: torch.Tensor      # (T, ph, bw)
    sp_panel: torch.Tensor          # (Tp,)
    sp_sub: torch.Tensor            # (Tp, S)
    sp_scatter: torch.Tensor        # (Tp, ph, bw)
    sp_colperm: torch.Tensor        # (H,)
    g_panel: torch.Tensor           # (Tg,)
    g_cols: torch.Tensor            # (Tg, bw)
    g_scatter: torch.Tensor         # (Tg, ph, bw)
    res_arow: torch.Tensor          # (E,)
    res_col: torch.Tensor           # (E,)
    res_out: torch.Tensor           # (E,)
    rphm_to_csr: torch.Tensor       # (nnz,)


def device_plan(plan: TilePlan, device, emit: str = "csr") -> DevicePlan:
    """Upload a TilePlan's arrays to ``device``.

    ``emit="rphm"`` uploads only what the rphm body reads and leaves the
    five output-placement maps (tile/sp/g scatter, res_out, rphm_to_csr)
    empty: they are most of a plan's bytes ((T, ph, bw) int32 per tier)
    and only CSR emission and the statistics need them."""
    device = torch.device(device)
    light = emit == "rphm"

    def up(arr, shape=(0,)):
        arr = np.zeros(shape, np.int32) if arr is None else arr
        return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(
            device)

    def maps(arr, shape=(0,)):
        return up(None) if light else up(arr, shape)

    return DevicePlan(
        row_perm_padded=up(plan.row_perm_padded),
        tile_panel=up(plan.tile_panel),
        tile_src=up(plan.step_cblock if plan.fat_group > 1
                    else plan.tile_cblock),
        tile_scatter=maps(plan.tile_scatter),
        sp_panel=up(plan.sp_panel),
        sp_sub=up(plan.sp_sub, (0, 1)),
        sp_scatter=maps(plan.sp_scatter,
                        (0, plan.panel_height, plan.block_width)),
        sp_colperm=up(plan.sp_colperm),
        g_panel=up(plan.g_panel),
        g_cols=up(plan.g_cols),
        g_scatter=maps(plan.g_scatter),
        res_arow=up(plan.res_arow),
        res_col=up(plan.res_col),
        res_out=maps(plan.res_out),
        rphm_to_csr=maps(plan.rphm_to_csr),
    )


def make_sddmm_body(plan: TilePlan, config: SddmmConfig,
                    backend: Optional[str] = None,
                    emit: str = "csr",
                    only_tier: Optional[str] = None) -> Callable:
    """Build ``fn(A, Bt, dplan)`` for one TilePlan.

    A is (M, K) and Bt = B^T is (N, K), both on the device of ``dplan``.
    ``emit="csr"`` returns (nnz,) values in CSR order; ``emit="rphm"``
    returns ``(dense (T, ph, bw), packed (Tp, ph, bw), gathered (Tg, ph,
    bw), residual (E,))``. ``only_tier`` ("dense" | "packed" | "gathered" |
    "residual") returns that tier's array alone. ``backend`` "auto" runs
    the hand kernels on CUDA tensors and their plain versions on CPU
    tensors; "torch" runs the plain versions everywhere."""
    backend = config.backend if backend is None else backend
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if emit not in ("csr", "rphm"):
        raise ValueError(f"unknown emit {emit!r}")
    if only_tier not in (None, "dense", "packed", "gathered", "residual"):
        raise ValueError(f"unknown only_tier {only_tier!r}")
    if plan.mode != "bsr":
        raise NotImplementedError(
            'col_mode="reorder" plans are not ported yet; see ROADMAP.md')
    ph, bw, k = plan.panel_height, plan.block_width, plan.k
    num_panels = max(plan.num_panels, 1)
    G = plan.fat_group
    Tp = plan.sp_panel.shape[0] if plan.sp_panel is not None else 0
    sw = plan.subblock_width
    out_dt = (torch.float16 if config.out_dtype == "float16"
              else torch.float32)
    plain = backend == "torch"
    dense_op = dk.bsr_dense_plain if plain else dk.bsr_dense
    packed_op = dk.subpack_plain if plain else dk.subpack

    def dense_out(A_panels, Bt, dplan):
        return dense_op(A_panels, Bt, dplan.tile_panel, dplan.tile_src,
                        fat_group=G, block_width=bw, out_dtype=out_dt)

    def packed_out(A_panels, Bt, dplan):
        if Tp == 0:
            return A_panels.new_empty((0, ph, bw), dtype=out_dt)
        Bt2 = Bt.index_select(0, dplan.sp_colperm)     # (H, K), once
        return packed_op(A_panels, Bt2, dplan.sp_panel, dplan.sp_sub,
                         subblock_width=sw, out_dtype=out_dt)

    def gathered_out(A_panels, Bt, dplan):
        Tg = dplan.g_panel.shape[0]
        b = Bt.index_select(0, dplan.g_cols.reshape(-1)).reshape(Tg, bw, k)
        a = A_panels.index_select(0, dplan.g_panel)
        return torch.bmm(a, b.transpose(1, 2)).to(out_dt)

    def residual_out(A_perm, Bt, dplan):
        a = A_perm.index_select(0, dplan.res_arow)
        b = Bt.index_select(0, dplan.res_col)
        return (a * b).sum(-1).to(out_dt)

    def fn(A: torch.Tensor, Bt: torch.Tensor, dplan: DevicePlan):
        A = A.to(torch.float32)
        Bt = Bt.to(torch.float32).contiguous()
        A_perm = A.index_select(0, dplan.row_perm_padded)     # (P*ph, K)
        A_panels = A_perm.reshape(num_panels, ph, k)
        if only_tier == "dense":
            return dense_out(A_panels, Bt, dplan)
        if only_tier == "packed":
            return packed_out(A_panels, Bt, dplan)
        if only_tier == "gathered":
            return gathered_out(A_panels, Bt, dplan)
        if only_tier == "residual":
            return residual_out(A_perm, Bt, dplan)
        tiers = (dense_out(A_panels, Bt, dplan),
                 packed_out(A_panels, Bt, dplan),
                 gathered_out(A_panels, Bt, dplan),
                 residual_out(A_perm, Bt, dplan))
        if emit == "rphm":
            return tiers
        big = torch.cat([t.reshape(-1) for t in tiers])
        return big.index_select(0, dplan.rphm_to_csr)

    return fn


def sddmm_ref(A: np.ndarray, B: np.ndarray, csr: CSR,
              chunk: int = 1 << 18) -> np.ndarray:
    """CPU oracle: P = (A @ B) sampled at the mask's nonzeros, in CSR value
    order (CUDA original sddmm_cpu, src/host.cpp:44-91), accumulated in
    fp64. The same function as ``bsmr_sddmm_tpu.ops.sddmm.sddmm_ref``."""
    rows = csr.coo_rows()
    cols = csr.col_indices
    out = np.empty(csr.nnz, dtype=np.float64)
    Bt = np.ascontiguousarray(B.T)
    for s in range(0, csr.nnz, chunk):
        e = min(s + chunk, csr.nnz)
        out[s:e] = np.einsum(
            "ij,ij->i",
            A[rows[s:e]].astype(np.float64),
            Bt[cols[s:e]].astype(np.float64))
    return out.astype(np.float32)
