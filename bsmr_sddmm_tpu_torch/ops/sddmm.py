"""Hybrid SDDMM body on PyTorch: two hand-kernel tile tiers, a gathered
tile tier and a per-nonzero residual.

The counterpart of ``bsmr_sddmm_tpu.ops.sddmm`` (``device_plan``,
``make_sddmm_body``, ``sddmm_ref``). Given A (M, K) and Bt = B^T (N, K):

1. ``A_perm = A[row_perm_padded]``, viewed as panels (P, ph, K);
2. dense tier: ``dense_kernels.bsr_dense`` over natural column blocks
   (``col_mode="bsr"``), or ``dense_kernels.dense_tile`` over each tile's
   own ``tile_cols`` (``col_mode="reorder"``), one launch over all tiles;
3. packed tier: ``dense_kernels.subpack``, which reads the hot columns
   ``Bt[sp_colperm]`` by index inside the kernel;
4. gathered tier: ``dense_kernels.fused_gathered`` where the JAX body takes
   its fused arm (``gathered_backend="fused"``, Tg > 0, no gather windows),
   else a row gather of each tile's bw columns and one ``bmm``;
5. residual: two row gathers and a multiply-sum per nonzero.

The output is the four tiers' arrays (``emit="rphm"``), one gather of
their concatenation along ``rphm_to_csr`` (``emit="csr"``, CSR value order),
or every padded slot of the four tiers scattered into a zero vector of
``nnz + 1`` values whose last slot takes the pad slots
(``emit="csr_scatter"``).
The residual and the unfused gathered tier are plain torch (the JAX package
leaves them to XLA too). They read ``config.tier_memory_mb`` as the JAX body
does: above ``E*K*8`` bytes (residual) or ``Tg*bw*K*4`` bytes (gathered) they
run in row chunks, which changes no value. The JAX body's gather windows
(``g_groups``, ``res_groups``) avoid a gather-rate cliff of its TPU; here
those plans run by absolute index, which gives the same values. Padded tail
slots are computed from valid pad indices; no slot past a tier's real count
is ever read by ``rphm_to_csr``. ``make_batched_sddmm_fn`` runs one plan over
a leading batch dimension.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.pack import TilePlan


class DevicePlan(NamedTuple):
    """A TilePlan's index arrays as int32 tensors on one device.
    ``tile_src`` holds, for a bsr plan, one column block per fat step
    (``step_cblock``, (T // G,)), or one per tile (``tile_cblock``) when
    the plan's fat group is 1; for a reorder plan, each tile's column ids
    (``tile_cols``, (T, bw))."""

    row_perm_padded: torch.Tensor   # (num_panels*ph,)
    tile_panel: torch.Tensor        # (T,)
    tile_src: torch.Tensor          # (T // G,) or (T, bw)
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


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; by default the CUDA device, and an
    error where there is none (the CPU runs only when asked for)."""
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(
        "no CUDA device: pass device='cpu' (or CPU tensors) to run the "
        "kernels' plain versions on the CPU")


def device_plan(plan: TilePlan, device, emit: str = "csr") -> DevicePlan:
    """Upload a TilePlan's arrays to ``device``.

    ``emit="rphm"`` uploads only what the rphm body reads and leaves the
    five output-placement maps (tile/sp/g scatter, res_out, rphm_to_csr)
    empty: they are most of a plan's bytes ((T, ph, bw) int32 per tier)
    and only CSR emission and the statistics need them."""
    device = torch.device(device)
    light = emit == "rphm"
    if plan.mode != "bsr":
        tile_src = plan.tile_cols
    elif plan.fat_group > 1:
        tile_src = plan.step_cblock
    else:
        tile_src = plan.tile_cblock

    def up(arr, shape=(0,)):
        arr = np.zeros(shape, np.int32) if arr is None else arr
        return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(
            device)

    def maps(arr, shape=(0,)):
        return up(None) if light else up(arr, shape)

    return DevicePlan(
        row_perm_padded=up(plan.row_perm_padded),
        tile_panel=up(plan.tile_panel),
        tile_src=up(tile_src),
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
    bw), residual (E,))``; ``emit="csr_scatter"`` returns (nnz + 1,)
    values: every slot of the four tiers written through its scatter map
    in the JAX body's order (dense, packed when Tp > 0, gathered,
    residual), pad slots into the trash slot ``nnz``, so ``[:nnz]`` is the
    CSR-order result. It reads the scatter maps, so it needs the full
    ``device_plan`` (not the ``emit="rphm"`` one). ``only_tier`` ("dense" | "packed" | "gathered" |
    "residual") returns that tier's array alone. ``backend`` "auto" runs
    the hand kernels on CUDA tensors and their plain versions on CPU
    tensors; "torch" runs the plain versions everywhere. The gathered tier
    runs ``fused_gathered`` exactly when the JAX body picks its fused arm:
    ``gathered_backend="fused"``, Tg > 0 and no gather windows."""
    backend = config.backend if backend is None else backend
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if emit not in ("csr", "rphm", "csr_scatter"):
        raise ValueError(f"unknown emit {emit!r}")
    if only_tier not in (None, "dense", "packed", "gathered", "residual"):
        raise ValueError(f"unknown only_tier {only_tier!r}")
    ph, bw, k = plan.panel_height, plan.block_width, plan.k
    nnz = plan.nnz
    num_panels = max(plan.num_panels, 1)
    G = plan.fat_group
    Tp = plan.sp_panel.shape[0] if plan.sp_panel is not None else 0
    sw = plan.subblock_width
    out_dt = (torch.float16 if config.out_dtype == "float16"
              else torch.float32)
    Tg = plan.g_panel.shape[0]
    fused = (config.gathered_backend == "fused" and Tg > 0
             and plan.g_groups is None)
    plain = backend == "torch"
    packed_op = dk.subpack_plain if plain else dk.subpack
    fused_op = dk.fused_gathered_plain if plain else dk.fused_gathered

    if plan.mode == "bsr":
        bsr_op = dk.bsr_dense_plain if plain else dk.bsr_dense

        def dense_out(A_panels, Bt, dplan):
            return bsr_op(A_panels, Bt, dplan.tile_panel, dplan.tile_src,
                          fat_group=G, block_width=bw, out_dtype=out_dt)
    else:
        tile_op = dk.dense_tile_plain if plain else dk.dense_tile

        def dense_out(A_panels, Bt, dplan):
            return tile_op(A_panels, Bt, dplan.tile_panel, dplan.tile_src,
                           out_dtype=out_dt)

    def packed_out(A_panels, Bt, dplan):
        if Tp == 0:
            return A_panels.new_empty((0, ph, bw), dtype=out_dt)
        return packed_op(A_panels, Bt, dplan.sp_colperm, dplan.sp_panel,
                         dplan.sp_sub, subblock_width=sw, out_dtype=out_dt)

    budget = config.tier_memory_mb << 20
    E = plan.res_arow.shape[0]
    # row chunks above the budget, as the JAX body cuts them
    # (bsmr_sddmm_tpu/ops/sddmm.py:464-479, 515-527)
    g_step = max(Tg, 1) if Tg * bw * k * 4 <= budget else _big_chunk(
        Tg, config.dense_chunk)
    r_step = max(E, 1) if E * k * 8 <= budget else _big_chunk(
        E, config.residual_chunk)

    def gathered_out(A_panels, Bt, dplan):
        if fused:
            return fused_op(A_panels, Bt, dplan.g_panel, dplan.g_cols,
                            out_dtype=out_dt)
        parts = []
        for s in range(0, Tg, g_step):
            cols = dplan.g_cols[s:s + g_step]
            b = Bt.index_select(0, cols.reshape(-1)).reshape(-1, bw, k)
            a = A_panels.index_select(0, dplan.g_panel[s:s + g_step])
            parts.append(torch.bmm(a, b.transpose(1, 2)).to(out_dt))
        return _joined(parts, (0, ph, bw), A_panels, out_dt)

    def residual_out(A_perm, Bt, dplan):
        parts = []
        for s in range(0, E, r_step):
            a = A_perm.index_select(0, dplan.res_arow[s:s + r_step])
            b = Bt.index_select(0, dplan.res_col[s:s + r_step])
            parts.append((a * b).sum(-1).to(out_dt))
        return _joined(parts, (0,), A_perm, out_dt)

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
        if emit == "csr":
            big = torch.cat([t.reshape(-1) for t in tiers])
            return big.index_select(0, dplan.rphm_to_csr)
        # "csr_scatter": every padded slot written through its map; only
        # the trash slot nnz takes more than one write
        maps = (dplan.tile_scatter, dplan.sp_scatter, dplan.g_scatter,
                dplan.res_out)
        if any(m.numel() != t.numel() for m, t in zip(maps, tiers)):
            raise ValueError("emit='csr_scatter' needs the scatter maps: "
                             "pass device_plan(plan, device) (emit='csr')")
        out = tiers[0].new_zeros(nnz + 1)
        for tier, m in zip(tiers, maps):    # an empty packed tier writes none
            out[m.reshape(-1).long()] = tier.reshape(-1)
        return out

    return fn


#: the JAX package's jitted entry point; PyTorch runs eagerly, so it is the
#: body itself
make_sddmm_fn = make_sddmm_body


def _chunk_of(n: int, want: int) -> int:
    """Largest chunk <= want that divides n exactly, else the gcd (the JAX
    body's ``_chunk_of``)."""
    c = max(8, min(want, n))
    return c if n % c == 0 else max(math.gcd(n, c), 1)


def _big_chunk(n: int, want: int) -> int:
    """The JAX body's chunk above the tier budget: ``n // 32`` rows where
    that is larger than the config's bucket and divides ``n``, else the
    bucket."""
    c = _chunk_of(n, want)
    big = max(c, n // 32)
    return big if n % big == 0 else c


def _joined(parts, empty_shape, like: torch.Tensor, dtype) -> torch.Tensor:
    """One chunk as it is; several concatenated; none an empty tier."""
    if not parts:
        return like.new_empty(empty_shape, dtype=dtype)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def make_batched_sddmm_fn(plan: TilePlan, config: SddmmConfig,
                          backend: Optional[str] = None,
                          emit: str = "csr") -> Callable:
    """Batched SDDMM over a leading Z dimension of both operands, one plan
    shared by the batch (``bsmr_sddmm_tpu.ops.sddmm.make_batched_sddmm_fn``;
    the CUDA original's sddmm_gpu_batch, src/sddmmKernel.cu:2764-2850):
    ``fn(A (Z, M, K), Bt (Z, N, K), dplan)``. The body runs once per batch
    element, so on the card every element goes through the hand kernels,
    and the results are stacked: ``(Z, nnz)`` for ``emit="csr"``, each of
    the four tiers stacked along Z for ``emit="rphm"``."""
    body = make_sddmm_body(plan, config, backend, emit=emit)

    def fn(A: torch.Tensor, Bt: torch.Tensor, dplan: DevicePlan):
        if A.dim() != 3 or Bt.dim() != 3 or A.shape[0] != Bt.shape[0]:
            raise ValueError(f"batched SDDMM needs A (Z, M, K) and Bt "
                             f"(Z, N, K), got {tuple(A.shape)} and "
                             f"{tuple(Bt.shape)}")
        outs = [body(A[z], Bt[z], dplan) for z in range(A.shape[0])]
        if emit == "rphm":
            return tuple(torch.stack(tier) for tier in zip(*outs))
        return torch.stack(outs)

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
