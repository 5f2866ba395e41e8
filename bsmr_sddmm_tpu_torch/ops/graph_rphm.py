"""Tile-native graph ops: edge softmax, SpMM and its transpose over the
rphm layout, and the SDDMM body as an autograd function.

The counterpart of ``bsmr_sddmm_tpu.ops.graph_rphm``. The body's
``emit="rphm"`` output is the plan's own four tiers (dense tiles, packed
tiles, gathered tiles, per-nonzero residual); these ops run the rest of
sparse attention in that layout, with no round trip through CSR order:

    scores (rphm) -> edge_softmax_rphm -> alpha (rphm)
    alpha (rphm), V -> spmm_rphm -> (M, F) node features

Row reductions are per-tile reductions plus segment ops over panels
(``scatter_reduce(..., "amax")`` and ``index_add``); the SpMM tiers are
per-tile (ph, bw) @ (bw, F) ``torch.bmm`` products. Those products, and
the ones of every backward here, run at the ``precision`` the ``make_*``
functions take, as the JAX ones do (default ``"high"``): in full fp32
whatever the caller's process set for TF32, except at ``"default"``, where
they may take one TF32 pass (``dense_kernels.tf32_matmuls``). The SpMM is
an autograd function with its own backward, so that no product is left to
autograd's later backward, outside that setting. On a CUDA device
``index_add`` sums in no fixed order, so results there agree with the
CPU's to a tolerance, not bit for bit.

``make_diff_sddmm_body`` makes the body differentiable: its forward is the
body (on CUDA tensors the hand kernels), its backward the two SpMMs
``dA = spmm(dP, Bt)`` and ``dBt = spmm_t(dP, A)``. The JAX package needs a
custom VJP for the same reason: a kernel has no autodiff rule.

Validity: a tile slot is real iff its scatter index is below nnz, so every
op here needs the full device plan (``device_plan(plan, device)``); the
light ``emit="rphm"`` plan leaves those maps empty and is refused.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.ops.sddmm import DevicePlan, precision_of
from bsmr_sddmm_tpu_torch.pack import TilePlan

_NEG = -1e30  # mask value; avoids inf - inf NaNs in empty rows


def require_full_plan(plan: TilePlan, dplan: DevicePlan) -> None:
    """Raise unless ``dplan`` carries the plan's scatter maps."""
    for name in ("tile_scatter", "g_scatter", "res_out"):
        if tuple(getattr(dplan, name).shape) != getattr(plan, name).shape:
            raise ValueError(
                f"graph ops read slot validity from {name}: pass the full "
                f"device plan, device_plan(plan, device), not the light "
                f"emit='rphm' one")


def _device_consts(**arrays) -> Callable:
    """``on(device)`` -> the arrays as tensors on ``device``, each uploaded
    once per device."""
    host = {name: torch.from_numpy(np.ascontiguousarray(arr))
            for name, arr in arrays.items() if arr is not None}
    cache = {}

    def on(device: torch.device) -> dict:
        if device not in cache:
            cache[device] = {name: t.to(device) for name, t in host.items()}
        return cache[device]

    return on


def _segment_sum(vals: torch.Tensor, ids: torch.Tensor,
                 n: int) -> torch.Tensor:
    return vals.new_zeros((n,) + tuple(vals.shape[1:])).index_add(0, ids,
                                                                  vals)


def _segment_max(vals: torch.Tensor, ids: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Per-segment max; -inf where a segment is empty."""
    idx = ids.long().reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    out = vals.new_full((n,) + tuple(vals.shape[1:]), -torch.inf)
    return out.scatter_reduce(0, idx, vals, "amax")


def _num_packed(plan: TilePlan) -> int:
    return plan.sp_panel.shape[0] if plan.sp_panel is not None else 0


def _column_map(plan: TilePlan) -> dict:
    """Where the dense tier's columns land: one column block per *tile*
    (``tile_cblock``; the device plan's ``tile_src`` holds one per fat step)
    on bsr plans, each tile's column ids clamped at N-1 on reorder plans."""
    if plan.tile_cblock is not None:
        return dict(tile_cblock=plan.tile_cblock)
    return dict(tile_cols=np.minimum(plan.tile_cols, max(plan.cols - 1, 0)))


def make_edge_softmax_rphm(plan: TilePlan) -> Callable:
    """``fn(dense, packed, gathered, res, dplan) -> the same four tiers``,
    each row's values softmax-normalised (numerically stable) in the rphm
    layout; slots that hold no nonzero come back 0."""
    P = max(plan.num_panels, 1)
    ph = plan.panel_height
    nnz = plan.nnz
    n_rows = P * ph
    Tp = _num_packed(plan)

    def fn(dense, packed, gathered, res, dplan: DevicePlan):
        require_full_plan(plan, dplan)
        tiers = [(dense.float(), dplan.tile_scatter < nnz, dplan.tile_panel),
                 (gathered.float(), dplan.g_scatter < nnz, dplan.g_panel)]
        if Tp:
            tiers.append((packed.float(), dplan.sp_scatter < nnz,
                          dplan.sp_panel))
        res = res.float()
        r_valid = dplan.res_out < nnz
        # the row max is a shift that softmax ignores: detached, so ties of
        # the max send no gradient anywhere
        with torch.no_grad():
            row_max = _segment_max(torch.where(r_valid, res, _NEG),
                                   dplan.res_arow, n_rows).reshape(P, ph)
            for vals, valid, panel in tiers:
                row_max = torch.maximum(row_max, _segment_max(
                    torch.where(valid, vals, _NEG).amax(2), panel, P))
            row_max = row_max.clamp_min(_NEG / 2)   # empty rows stay finite

        def exp(vals, valid, shift):
            # exp of the shifted value on real slots only: a pad slot of an
            # empty row would overflow, and its inf would turn the gradient
            # of the mask into NaN
            return torch.where(valid, torch.exp(
                torch.where(valid, vals - shift, 0.0)), 0.0)

        flat_max = row_max.reshape(-1)
        exps = [exp(vals, valid, row_max.index_select(0, panel)[:, :, None])
                for vals, valid, panel in tiers]
        r_exp = exp(res, r_valid, flat_max.index_select(0, dplan.res_arow))
        denom = (_segment_sum(exps[0].sum(2), dplan.tile_panel, P)
                 + _segment_sum(exps[1].sum(2), dplan.g_panel, P)
                 + _segment_sum(r_exp, dplan.res_arow, n_rows).reshape(P, ph))
        if Tp:
            denom = denom + _segment_sum(exps[2].sum(2), dplan.sp_panel, P)
        denom = denom.clamp_min(1e-20)
        out = [e / denom.index_select(0, panel)[:, :, None]
               for e, (_, _, panel) in zip(exps, tiers)]
        return (out[0], out[2] if Tp else packed, out[1],
                r_exp / denom.reshape(-1).index_select(0, dplan.res_arow))

    return fn


def _v_blocks(plan: TilePlan, c: dict, dplan: DevicePlan,
              Vp: torch.Tensor) -> tuple:
    """The rows of the padded ``Vp`` (n_cblocks * bw, F) that each tile
    slot column meets: ``(dense (T, bw, F), packed (Tp, bw, F) or None,
    gathered (Tg, bw, F))``. Dense tiles take contiguous blocks on bsr
    plans and rows by ``tile_cols`` on reorder plans; packed tiles rows
    through ``sp_colperm`` and ``sp_sub``; gathered tiles rows by
    ``g_cols``."""
    bw, nf = plan.block_width, Vp.shape[1]
    if "tile_cblock" in c:
        vb = Vp.reshape(-1, bw, nf).index_select(0, c["tile_cblock"])
    else:
        vb = Vp.index_select(0, c["tile_cols"].reshape(-1)).reshape(-1, bw,
                                                                    nf)
    vb_pk = None
    if _num_packed(plan):
        V_sub = Vp.index_select(0, dplan.sp_colperm).reshape(
            -1, plan.subblock_width, nf)
        vb_pk = V_sub.index_select(0, dplan.sp_sub.reshape(-1)).reshape(
            -1, bw, nf)
    vg = Vp.index_select(0, dplan.g_cols.reshape(-1)).reshape(-1, bw, nf)
    return vb, vb_pk, vg


def _spmm_parts(plan: TilePlan, precision: str) -> tuple:
    """``(forward, sampled)``, the untracked halves of the SpMM, their
    products at ``precision``.

    ``forward(dense, packed, gathered, res, V, dplan) -> (M, F)`` is the
    SpMM itself. ``sampled(G (M, F), V (N, F), dplan) -> four tiers`` is
    its gradient with respect to the values: ``G[row] . V[col]`` at every
    real slot, 0 at pad slots (the same products as the SDDMM, of ``G``
    and ``V``)."""
    P = max(plan.num_panels, 1)
    ph, bw = plan.panel_height, plan.block_width
    nnz, N, M = plan.nnz, plan.cols, plan.rows
    n_rows = P * ph
    n_pad = -(-N // bw) * bw
    Tp = _num_packed(plan)
    # row r sits at position inv_pos[r] of the permuted layout; pad slots
    # repeat row 0 after its real slot, so the first occurrence is the real
    # one; rows absent from the permutation read the zero row at n_rows. On
    # a shard plan (pack_shard_plans) row 0 may be another shard's: its
    # first occurrence is then a pad row, whose slots are all invalid, so
    # the row comes back exactly 0 and sends no gradient
    inv_pos = np.full(M, n_rows, np.int64)
    uniq, first = np.unique(plan.row_perm_padded.astype(np.int64),
                            return_index=True)
    inv_pos[uniq] = first
    consts = _device_consts(inv_pos=inv_pos, **_column_map(plan))
    _, tf32 = precision_of(precision)   # one TF32 pass only at "default"

    def forward(dense, packed, gathered, res, V, dplan: DevicePlan):
        c = consts(V.device)
        nf = V.shape[1]
        # zero the pad slots: their values are whatever the padded products
        # computed
        dense = torch.where(dplan.tile_scatter < nnz, dense.float(), 0.0)
        gathered = torch.where(dplan.g_scatter < nnz, gathered.float(), 0.0)
        res = torch.where(dplan.res_out < nnz, res.float(), 0.0)
        Vp = F.pad(V.float(), (0, 0, 0, n_pad - N))
        vb, vb_pk, vg = _v_blocks(plan, c, dplan, Vp)
        with dk.tf32_matmuls(tf32):
            out = _segment_sum(torch.bmm(dense, vb), dplan.tile_panel, P)
            if Tp:
                packed = torch.where(dplan.sp_scatter < nnz, packed.float(),
                                     0.0)
                out = out + _segment_sum(torch.bmm(packed, vb_pk),
                                         dplan.sp_panel, P)
            out = out + _segment_sum(torch.bmm(gathered, vg), dplan.g_panel,
                                     P)
        out = out.reshape(n_rows, nf)
        out = out + _segment_sum(Vp.index_select(0, dplan.res_col)
                                 * res[:, None], dplan.res_arow, n_rows)
        out = torch.cat([out, out.new_zeros(1, nf)])
        return out.index_select(0, c["inv_pos"])

    def sampled(G, V, dplan: DevicePlan):
        c = consts(V.device)
        G_perm = G.float().index_select(0, dplan.row_perm_padded)
        G_panels = G_perm.reshape(P, ph, -1)
        Vp = F.pad(V.float(), (0, 0, 0, n_pad - N))
        vb, vb_pk, vg = _v_blocks(plan, c, dplan, Vp)

        def tile_dots(panel, blocks, scatter):
            with dk.tf32_matmuls(tf32):
                dots = torch.bmm(G_panels.index_select(0, panel),
                                 blocks.transpose(1, 2))
            return torch.where(scatter < nnz, dots, 0.0)

        d_packed = (tile_dots(dplan.sp_panel, vb_pk, dplan.sp_scatter) if Tp
                    else G.new_zeros((0, ph, bw), dtype=torch.float32))
        d_res = (G_perm.index_select(0, dplan.res_arow)
                 * Vp.index_select(0, dplan.res_col)).sum(1)
        return (tile_dots(dplan.tile_panel, vb, dplan.tile_scatter), d_packed,
                tile_dots(dplan.g_panel, vg, dplan.g_scatter),
                torch.where(dplan.res_out < nnz, d_res, 0.0))

    return forward, sampled


class _Spmm(torch.autograd.Function):
    """The SpMM with its own backward, so that the backward's products run
    at the forward's precision too: autograd's backward of the forward's
    ``bmm``s would run later, outside that setting, at whatever
    ``allow_tf32`` the caller set by then. ``d vals = sampled(d out, V)``,
    ``dV = SpMM^T(vals, d out)``."""

    @staticmethod
    def forward(ctx, dense, packed, gathered, res, V, dplan, forward,
                sampled, spmm_t):
        ctx.save_for_backward(dense, packed, gathered, res, V)
        ctx.dplan, ctx.sampled, ctx.spmm_t = dplan, sampled, spmm_t
        return forward(dense, packed, gathered, res, V, dplan)

    @staticmethod
    def backward(ctx, d_out):
        *vals, V = ctx.saved_tensors
        grads = [None] * 5
        with record_function("bsmr::spmm_backward"):
            if any(ctx.needs_input_grad[:4]):
                for i, (g, x) in enumerate(zip(
                        ctx.sampled(d_out, V, ctx.dplan), vals)):
                    if ctx.needs_input_grad[i]:
                        grads[i] = g.to(x.dtype)
            if ctx.needs_input_grad[4]:
                grads[4] = ctx.spmm_t(*vals, d_out, ctx.dplan).to(V.dtype)
        return (*grads, None, None, None, None)


def make_spmm_rphm(plan: TilePlan, precision: str = "high") -> Callable:
    """``fn(dense, packed, gathered, res, V, dplan) -> (M, F)``: ``out[r] =
    sum_e vals[e] * V[col[e]]``, values in the rphm layout, the output in
    the ORIGINAL row order (rows the plan holds no nonzero of come back
    exactly 0). Per-tile products against the V rows each tile's columns
    meet (:func:`_v_blocks`), the residual per nonzero. Differentiable in
    the values and ``V``, its backward at ``precision`` as well (a
    ``matmul_precision`` value: fp32 but at "default")."""
    forward, sampled = _spmm_parts(plan, precision)
    spmm_t = make_spmm_transpose_rphm(plan, precision)

    def fn(dense, packed, gathered, res, V, dplan: DevicePlan):
        require_full_plan(plan, dplan)
        return _Spmm.apply(dense, packed, gathered, res, V, dplan, forward,
                           sampled, spmm_t)

    return fn


def make_spmm_transpose_rphm(plan: TilePlan,
                             precision: str = "high") -> Callable:
    """``fn(dense, packed, gathered, res, A_full, dplan) -> (N, F)``: the
    column-side aggregation ``out[c] = sum_e vals[e] * A[row_e]``, the
    transpose of :func:`make_spmm_rphm` (the SDDMM's dB^T). Dense tier
    summed per column block on bsr plans, added per tile column on reorder
    plans; packed tiles land at ``sp_colperm[sp_sub * sw + j]``; gathered
    tiles at ``g_cols``; residual per nonzero; products at ``precision``.
    Used in backward passes only, so not differentiable itself."""
    P = max(plan.num_panels, 1)
    ph, bw = plan.panel_height, plan.block_width
    nnz, N = plan.nnz, plan.cols
    n_cblocks = -(-N // bw)
    n_pad = n_cblocks * bw
    Tp = _num_packed(plan)
    sw = plan.subblock_width
    consts = _device_consts(sub_offsets=np.arange(max(sw, 1), dtype=np.int32),
                            **_column_map(plan))
    _, tf32 = precision_of(precision)

    def fn(dense, packed, gathered, res, A_full, dplan: DevicePlan):
        require_full_plan(plan, dplan)
        c = consts(A_full.device)
        nf = A_full.shape[1]
        dense = torch.where(dplan.tile_scatter < nnz, dense.float(), 0.0)
        gathered = torch.where(dplan.g_scatter < nnz, gathered.float(), 0.0)
        res = torch.where(dplan.res_out < nnz, res.float(), 0.0)
        A_perm = A_full.float().index_select(0, dplan.row_perm_padded)
        A_panels = A_perm.reshape(P, ph, nf)
        with dk.tf32_matmuls(tf32):
            d_part = torch.bmm(dense.transpose(1, 2),
                               A_panels.index_select(0, dplan.tile_panel))
            if "tile_cblock" in c:
                out = _segment_sum(d_part, c["tile_cblock"],
                                   n_cblocks).reshape(n_pad, nf)
            else:
                out = _segment_sum(d_part.reshape(-1, nf),
                                   c["tile_cols"].reshape(-1), n_pad)
            if Tp:
                packed = torch.where(dplan.sp_scatter < nnz, packed.float(),
                                     0.0)
                p_part = torch.bmm(packed.transpose(1, 2),
                                   A_panels.index_select(0, dplan.sp_panel))
                pk_pos = dplan.sp_sub[:, :, None] * sw + c["sub_offsets"]
                pk_cols = dplan.sp_colperm.index_select(0, pk_pos.reshape(-1))
                out = out + _segment_sum(p_part.reshape(-1, nf), pk_cols,
                                         n_pad)
            g_part = torch.bmm(gathered.transpose(1, 2),
                               A_panels.index_select(0, dplan.g_panel))
            out = out + _segment_sum(g_part.reshape(-1, nf),
                                     dplan.g_cols.reshape(-1), n_pad)
        out = out + _segment_sum(A_perm.index_select(0, dplan.res_arow)
                                 * res[:, None], dplan.res_col, n_pad)
        return out[:N]

    return fn


class _DiffSddmm(torch.autograd.Function):
    """The SDDMM body with the tile-native SpMMs as its backward. An
    output whose gradient is None counts as zeros (autograd materialises
    it, e.g. the (0, ph, bw) packed tier of a plan with no packed tile)."""

    @staticmethod
    def forward(ctx, A, Bt, dplan, body, spmm, spmm_t):
        ctx.save_for_backward(A, Bt)
        ctx.dplan, ctx.spmm, ctx.spmm_t = dplan, spmm, spmm_t
        with record_function("bsmr::sddmm_body"):
            return tuple(body(A, Bt, dplan))

    @staticmethod
    def backward(ctx, d_dense, d_pk, d_gath, d_res):
        A, Bt = ctx.saved_tensors
        grads = (d_dense, d_pk, d_gath, d_res)
        dA = dBt = None
        with record_function("bsmr::spmm_backward"):
            if ctx.needs_input_grad[0]:
                dA = ctx.spmm(*grads, Bt, ctx.dplan).to(A.dtype)
            if ctx.needs_input_grad[1]:
                dBt = ctx.spmm_t(*grads, A, ctx.dplan).to(Bt.dtype)
        return dA, dBt, None, None, None, None


def make_diff_sddmm_body(plan: TilePlan, body: Callable,
                         precision: str = "high") -> Callable:
    """Wrap a ``make_sddmm_body(..., emit="rphm")`` callable so that
    autograd differentiates through it: ``fn(A, Bt, dplan) -> (dense,
    packed, gathered, res)``, backward ``dA = SpMM(dP, B^T)`` and ``dB^T =
    SpMM^T(dP, A)`` at ``precision``. ``dplan`` must be the full device
    plan."""
    spmm = make_spmm_rphm(plan, precision)
    spmm_t = make_spmm_transpose_rphm(plan, precision)

    def diff_body(A: torch.Tensor, Bt: torch.Tensor, dplan: DevicePlan):
        require_full_plan(plan, dplan)
        return _DiffSddmm.apply(A, Bt, dplan, body, spmm, spmm_t)

    return diff_body


def make_sparse_attention_rphm(plan: TilePlan, body: Callable,
                               precision: str = "high") -> Callable:
    """One attention head in the tile layout: ``fn(q, k, v, dplan) -> (M,
    F) = SpMM(softmax(SDDMM(q, k) / sqrt(dk)), v)``, differentiable end to
    end (the SDDMM through :func:`make_diff_sddmm_body`, the SpMM through
    its own backward, the softmax through torch's own rules), the SpMMs'
    products at ``precision`` (the body runs at its config's). ``body``
    is a ``make_sddmm_body(..., emit="rphm")`` callable. Over a mesh one
    head is built per shard plan around one body of ``plans[0]``: the
    shapes are common, the constants (column map, row positions) each
    plan's own."""
    softmax = make_edge_softmax_rphm(plan)
    spmm = make_spmm_rphm(plan, precision)
    diff_body = make_diff_sddmm_body(plan, body, precision)
    inv_sqrt = float(1.0 / np.sqrt(plan.k))

    def fn(q: torch.Tensor, kk: torch.Tensor, v: torch.Tensor,
           dplan: DevicePlan) -> torch.Tensor:
        d, p, g, r = diff_body(q, kk, dplan)
        d, p, g, r = softmax(d * inv_sqrt, p * inv_sqrt, g * inv_sqrt,
                             r * inv_sqrt, dplan)
        return spmm(d, p, g, r, v, dplan)

    return fn
