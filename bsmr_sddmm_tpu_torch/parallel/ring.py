"""Ring execution: B-panel rotation between shards, no all-gather.

The counterpart of ``bsmr_sddmm_tpu.parallel.ring``. The b-sharded path of
:mod:`bsmr_sddmm_tpu_torch.parallel.sharding` does one ``all_gather`` of B
before any compute — every product waits for the full (N, K) operand. This
module keeps B sharded the whole time: shard d starts holding B panel d
((w, K) rows of B^T), computes the part of its row shard's SDDMM whose
mask columns fall in that panel, and passes the panel to its ring
neighbour (:func:`collectives.ring_shift`: within a process a copy
between devices, none where the shards share one; across processes a
send and a receive posted together). Peak B memory per shard is one
panel (two while a hop is in flight) instead of the full N*K.

Packing: each (row-panel shard, B panel) pair gets a static-shaped tile
group. Tiers are dense BSR tiles + panel-local GATHERED tiles + per-nnz
residual: a gathered tile's columns all live in one B panel, so its row
gather reads the resident (w, K) panel. The packed (hot-column) tier
needs a global column permutation of B and stays on the all-gather path
(``scaling_model.choose_layout`` prices the two layouts).

Each step runs the hand kernels the single-device body runs: the dense
tier is ``dense_kernels.bsr_dense`` over panel-local column blocks of the
resident panel (fat group 1), the gathered tier ``dense_kernels.
dense_tile`` over panel-local columns, and the residual two row gathers
and a multiply-sum. (The JAX body computes the two tile tiers with XLA's
``dot_general``.) A call launches each tile kernel n times per shard.
``config.matmul_precision`` sets the kernels' TF32 pass count as it does
in the body (``ops.sddmm.PRECISION``); the ring has no torch matmul of its
own (the plain versions of ``backend="torch"`` follow the pass count).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.ops.sddmm import precision_of
from bsmr_sddmm_tpu_torch.parallel import collectives
from bsmr_sddmm_tpu_torch.parallel.sharding import Mesh, put_global
from bsmr_sddmm_tpu_torch.reorder import BsmrReordering, _concat_ranges


@dataclasses.dataclass
class RingPlan:
    """Static-shaped per-(shard, B-panel) packing for the ring body.

    Arrays are (n_shards, n_panels, ...): shard s uploads its row (n_panels,
    ...) — its own row shard's groups, indexed by the B panel it
    currently holds.
    """

    n: int                      # mesh size = ring length = B panel count
    rows: int
    cols: int                   # original N
    w: int                      # B panel width (rows of Bt), n * w >= N
    nnz: int
    k: int
    panel_height: int
    block_width: int
    panels_per_shard: int       # P_l: row panels per shard (padded common)
    tiles_per_group: int        # Td
    tiles_g_per_group: int      # Tg (0 = gathered tier off)
    res_per_group: int          # E
    num_gathered: int           # total real gathered tiles across groups

    row_perm: np.ndarray        # (n, P_l * ph) int32 (pad: 0)
    tile_rpanel: np.ndarray     # (n, n, Td) int32 local row panel
    tile_cb: np.ndarray         # (n, n, Td) int32 cblock LOCAL to panel
    tile_scatter: np.ndarray    # (n, n, Td, ph, bw) int32 into [0, nnz]
    g_rpanel: np.ndarray        # (n, n, Tg) int32 local row panel
    g_cols_l: np.ndarray        # (n, n, Tg, bw) int32 cols LOCAL to panel
    g_scatter: np.ndarray       # (n, n, Tg, ph, bw) int32 into [0, nnz]
    res_arow: np.ndarray        # (n, n, E) int32 local permuted A row
    res_col: np.ndarray         # (n, n, E) int32 col LOCAL to panel
    res_out: np.ndarray         # (n, n, E) int32 into [0, nnz]
    rphm_to_csr: np.ndarray     # (nnz,) int32 into the stacked outputs


def pack_ring_plans(csr: CSR, reord: BsmrReordering,
                    config: SddmmConfig, n_shards: int,
                    k: Optional[int] = None) -> RingPlan:
    """Pack the mask for the ring: nnz-balanced contiguous row-panel
    shards (as pack_shard_plans), then per shard a (B panel) -> tile
    group split. Dense tiles are the natural 128-wide column blocks
    whose in-panel count meets delta (col_mode="bsr" semantics,
    reference colReordering.cu:246-261 re-thresholded at tile width);
    everything else is per-nnz residual grouped by B panel."""
    k = config.k if k is None else k
    ph, bw = config.panel_height, config.block_width
    n = n_shards
    N = csr.cols
    nnz = csr.nnz
    # B panel width: multiple of bw, n panels cover N
    per = -(-N // n)           # ceil(N / n)
    w = -(-per // bw) * bw     # rounded up to a cblock multiple
    cb_per_panel = w // bw
    thresh = max(int(np.ceil(config.delta * ph * bw)), 1)

    perm = reord.row_perm.astype(np.int64)
    R = perm.shape[0]
    num_panels = -(-R // ph)
    # cost-balanced contiguous shard bounds (panel_cost_weights uses the
    # single-chip column split as the tile-count proxy; the ring's own
    # dense membership is the natural-block threshold, which correlates —
    # either beats nnz-only balancing on power-law masks)
    if reord.dense_cols is not None and reord.num_row_panels == num_panels:
        from bsmr_sddmm_tpu_torch.pack import panel_cost_weights
        weights = panel_cost_weights(csr, reord, config, k=k)
    else:
        row_nnz = csr.row_nnz()[perm]
        pad_rows = num_panels * ph - R
        weights = np.concatenate(
            [row_nnz, np.zeros(pad_rows, np.int64)]) \
            .reshape(num_panels, ph).sum(axis=1).astype(np.float64)
    cum = np.concatenate([[0.0], np.cumsum(weights)])
    targets = cum[-1] * np.arange(1, n) / n
    bounds = np.concatenate([[0], np.searchsorted(cum, targets),
                             [num_panels]]).astype(np.int64)
    bounds = np.maximum.accumulate(bounds)
    P_l = max(int((bounds[1:] - bounds[:-1]).max()), 1)

    shards = []
    Td_max, E_max, Tg_max = 1, 1, 0
    for s in range(n):
        p0, p1 = int(bounds[s]), int(bounds[s + 1])
        rows = perm[p0 * ph: min(p1 * ph, R)]
        rn = csr.row_nnz()[rows]
        pos = np.repeat(np.arange(rows.shape[0], dtype=np.int64), rn)
        eidx = _concat_ranges(csr.row_offsets[rows], rn)
        cols = csr.col_indices[eidx].astype(np.int64)
        rpanel = pos // ph
        lrow = pos % ph
        cblock = cols // bw
        bpanel = cols // w
        # dense membership: (rpanel, cblock) counts
        keyc = rpanel * np.int64(cb_per_panel * n + 1) + cblock
        order = np.argsort(keyc, kind="stable")
        ks = keyc[order]
        uq_pos = np.nonzero(np.diff(ks, prepend=-1))[0]
        uq_cnt = np.diff(np.append(uq_pos, ks.shape[0]))
        qual = uq_cnt >= thresh
        ent_uq = np.searchsorted(ks[uq_pos], keyc)
        is_dense = qual[ent_uq]
        # tiles grouped by B panel
        q_key = ks[uq_pos][qual]
        q_rp = q_key // np.int64(cb_per_panel * n + 1)
        q_cb = q_key % np.int64(cb_per_panel * n + 1)
        q_bp = q_cb // cb_per_panel
        tile_of_uq = np.full(uq_pos.shape[0], -1, np.int64)
        # order tiles by (b panel, rpanel, cblock): group-local ids
        t_order = np.lexsort((q_cb, q_rp, q_bp))
        q_rp, q_cb, q_bp = q_rp[t_order], q_cb[t_order], q_bp[t_order]
        grp_counts = np.bincount(q_bp, minlength=n)
        Td_max = max(Td_max, int(grp_counts.max()) if q_bp.size else 0)
        within = np.arange(q_bp.shape[0]) - np.concatenate(
            [[0], np.cumsum(grp_counts)])[q_bp]
        qual_ids = np.nonzero(qual)[0][t_order]
        tile_of_uq[qual_ids] = q_bp * (1 << 32) + within  # packed (bp, id)
        # gathered tier: residual (rpanel, col) pairs chunked bw-wide per
        # (B panel, rpanel), count-descending — the single-chip gathered
        # tier per ring step. A chunk qualifies when it covers at least
        # residual_tile_min_nnz nonzeros; the rest stays per-nnz.
        res_m = ~is_dense
        in_g = np.zeros(pos.shape[0], dtype=bool)
        g_bp_e = np.zeros(pos.shape[0], np.int64)
        g_tile_e = np.zeros(pos.shape[0], np.int64)
        g_slot_e = np.zeros(pos.shape[0], np.int64)
        g_meta = {}   # bpanel -> (rpanel_per_tile, cols_per_tile (Tg,bw))
        if config.residual_mode == "gathered" and res_m.any():
            ridx = np.nonzero(res_m)[0]
            key = rpanel[ridx] * np.int64(N + 1) + cols[ridx]
            korder = np.argsort(key, kind="stable")
            ks2 = key[korder]
            upos = np.nonzero(np.diff(ks2, prepend=-1))[0]
            ukey = ks2[upos]                      # ascending
            ucnt = np.diff(np.append(upos, ks2.shape[0]))
            u_rp = ukey // np.int64(N + 1)
            u_col = ukey % np.int64(N + 1)
            u_bp = u_col // w
            # (bpanel, rpanel, count desc, col) order, chunked bw-wide
            # within each (bpanel, rpanel) segment
            uorder = np.lexsort((u_col, -ucnt, u_rp, u_bp))
            s_rp, s_col, s_bp = u_rp[uorder], u_col[uorder], u_bp[uorder]
            s_cnt = ucnt[uorder]
            U = uorder.shape[0]
            seg = s_bp * np.int64(P_l + 1) + s_rp
            seg_starts = np.nonzero(np.diff(seg, prepend=-1))[0]
            seg_of = np.searchsorted(seg_starts, np.arange(U),
                                     side="right") - 1
            within = np.arange(U) - seg_starts[seg_of]
            chunk_of = within // bw
            slot_of = within % bw
            ckey = seg_of.astype(np.int64) * np.int64(U + 1) + chunk_of
            cpos = np.nonzero(np.diff(ckey, prepend=-1))[0]
            chunk_nnz = np.add.reduceat(s_cnt, cpos)
            keep_chunk = chunk_nnz >= config.residual_tile_min_nnz
            col_chunk = np.searchsorted(cpos, np.arange(U),
                                        side="right") - 1
            if keep_chunk.any():
                kept = np.nonzero(keep_chunk)[0]
                bp_of_chunk = s_bp[cpos]
                # tile id within its bpanel group (stable order)
                tile_of_chunk = np.full(keep_chunk.shape[0], -1, np.int64)
                kept_bp = bp_of_chunk[kept]
                gcounts = np.bincount(kept_bp, minlength=n)
                gbase = np.zeros(n, np.int64)
                np.cumsum(gcounts[:-1], out=gbase[1:])
                # within-group id: kept is ascending and chunks of one
                # bpanel are contiguous in (bp, rp, ...) order, so
                # arange - first-kept-of-group enumerates each group
                tile_of_chunk[kept] = (np.arange(kept.shape[0])
                                       - gbase[kept_bp])
                Tg_max = max(Tg_max, int(gcounts.max()))
                # per-tile column lists, vectorized over ALL kept chunks
                # at once (a big mask can have 100k+ tiles — a Python
                # loop here bound the host side): each chunk's <=bw
                # unique cols land in one row of (Kc, bw); pad slots
                # repeat the chunk's first col (gather stays in-panel,
                # scatter slots are trash)
                cstarts = cpos[kept]
                lens = np.append(cpos, U)[kept + 1] - cstarts
                lane = np.arange(bw)
                src = cstarts[:, None] + np.where(lane < lens[:, None],
                                                  lane, 0)
                cols_all = (s_col[src]
                            - kept_bp[:, None] * w).astype(np.int32)
                rp_all = s_rp[cstarts].astype(np.int32)
                # kept chunks are (bpanel, ...)-sorted, so each group is
                # a contiguous slice
                for p in np.nonzero(gcounts)[0]:
                    s0, s1 = np.searchsorted(kept_bp, [p, p + 1])
                    g_meta[int(p)] = (rp_all[s0:s1], cols_all[s0:s1])
                # route entries through their unique col's chunk
                inv_uorder = np.empty(U, np.int64)
                inv_uorder[uorder] = np.arange(U)
                ent_u = inv_uorder[np.searchsorted(ukey, key)]
                ent_chunk = col_chunk[ent_u]
                ent_kept = keep_chunk[ent_chunk]
                gsel = ridx[ent_kept]
                in_g[gsel] = True
                g_bp_e[gsel] = s_bp[ent_u[ent_kept]]
                g_tile_e[gsel] = tile_of_chunk[ent_chunk[ent_kept]]
                g_slot_e[gsel] = slot_of[ent_u[ent_kept]]
        res_counts = np.bincount(bpanel[res_m & ~in_g], minlength=n)
        E_max = max(E_max, int(res_counts.max()) if res_counts.size else 0)
        shards.append(dict(
            rows=rows, eidx=eidx, cols=cols, rpanel=rpanel, lrow=lrow,
            cblock=cblock, bpanel=bpanel, is_dense=is_dense,
            ent_uq=ent_uq, tile_of_uq=tile_of_uq,
            q_rp=q_rp, q_cb=q_cb, q_bp=q_bp, grp_counts=grp_counts,
            in_g=in_g, g_bp_e=g_bp_e, g_tile_e=g_tile_e,
            g_slot_e=g_slot_e, g_meta=g_meta))

    Td = max(Td_max, 1)
    E = max(E_max, 1)
    Tg = Tg_max   # 0 = gathered tier absent (static, drops its compute)
    row_perm_arr = np.zeros((n, P_l * ph), np.int32)
    tile_rpanel = np.zeros((n, n, Td), np.int32)
    tile_cb = np.zeros((n, n, Td), np.int32)
    tile_scatter = np.full((n, n, Td, ph, bw), nnz, np.int32)
    g_rpanel = np.zeros((n, n, Tg), np.int32)
    g_cols_l = np.zeros((n, n, Tg, bw), np.int32)
    g_scatter = np.full((n, n, Tg, ph, bw), nnz, np.int32)
    num_gathered = 0
    res_arow = np.zeros((n, n, E), np.int32)
    res_col = np.zeros((n, n, E), np.int32)
    res_out = np.full((n, n, E), nnz, np.int32)

    for s, sh in enumerate(shards):
        row_perm_arr[s, :sh["rows"].shape[0]] = sh["rows"]
        # tiles
        gc = sh["grp_counts"]
        for p in np.nonzero(gc)[0]:
            m = sh["q_bp"] == p
            cnt = int(gc[p])
            tile_rpanel[s, p, :cnt] = sh["q_rp"][m]
            tile_cb[s, p, :cnt] = sh["q_cb"][m] - p * cb_per_panel
        # dense entries -> scatter
        de = sh["is_dense"]
        packed = sh["tile_of_uq"][sh["ent_uq"][de]]
        bp_of_e = (packed >> 32).astype(np.int64)
        tid_of_e = (packed & ((1 << 32) - 1)).astype(np.int64)
        tile_scatter[s, bp_of_e, tid_of_e, sh["lrow"][de],
                     sh["cols"][de] % bw] = sh["eidx"][de]
        # gathered tiles: per-(bpanel) metadata + entry scatter
        for p, (rp_t, cols_t) in sh["g_meta"].items():
            cnt = rp_t.shape[0]
            num_gathered += cnt
            g_rpanel[s, p, :cnt] = rp_t
            g_cols_l[s, p, :cnt] = cols_t
        ge = sh["in_g"]
        if ge.any():
            g_scatter[s, sh["g_bp_e"][ge], sh["g_tile_e"][ge],
                      sh["lrow"][ge], sh["g_slot_e"][ge]] = sh["eidx"][ge]
        # residual entries grouped by b panel
        re_m = ~de & ~ge
        rbp = sh["bpanel"][re_m]
        order = np.argsort(rbp, kind="stable")
        rbp_s = rbp[order]
        starts = np.searchsorted(rbp_s, np.arange(n))
        ends = np.searchsorted(rbp_s, np.arange(n), side="right")
        r_pos = sh["rpanel"][re_m][order] * ph + sh["lrow"][re_m][order]
        r_col = sh["cols"][re_m][order]
        r_idx = sh["eidx"][re_m][order]
        for p in range(n):
            s0, e0 = int(starts[p]), int(ends[p])
            cnt = e0 - s0
            if not cnt:
                continue
            res_arow[s, p, :cnt] = r_pos[s0:e0]
            res_col[s, p, :cnt] = r_col[s0:e0] - p * w
            res_out[s, p, :cnt] = r_idx[s0:e0]

    # inverse map into the stacked ring outputs:
    # [dense (s*n + p)*Td*ph*bw + ... | gathered | residual]
    d_total = n * n * Td * ph * bw
    g_total = n * n * Tg * ph * bw
    if d_total + g_total + n * n * E >= np.iinfo(np.int32).max:
        raise ValueError("ring rphm layout exceeds int32 indexing — lower "
                         "n_shards or use the all-gather path")
    rphm_to_csr = np.zeros(nnz, np.int32)
    ts = tile_scatter.reshape(-1)
    m = ts < nnz
    rphm_to_csr[ts[m]] = np.nonzero(m)[0].astype(np.int32)
    if Tg:
        gs = g_scatter.reshape(-1)
        m = gs < nnz
        rphm_to_csr[gs[m]] = (np.nonzero(m)[0] + d_total).astype(np.int32)
    ro = res_out.reshape(-1)
    m = ro < nnz
    rphm_to_csr[ro[m]] = (np.nonzero(m)[0] + d_total
                          + g_total).astype(np.int32)

    return RingPlan(
        n=n, rows=csr.rows, cols=N, w=w, nnz=nnz, k=k,
        panel_height=ph, block_width=bw, panels_per_shard=P_l,
        tiles_per_group=Td, tiles_g_per_group=Tg, res_per_group=E,
        num_gathered=num_gathered,
        row_perm=row_perm_arr, tile_rpanel=tile_rpanel, tile_cb=tile_cb,
        tile_scatter=tile_scatter, g_rpanel=g_rpanel, g_cols_l=g_cols_l,
        g_scatter=g_scatter, res_arow=res_arow, res_col=res_col,
        res_out=res_out, rphm_to_csr=rphm_to_csr)


def ring_operands(A, Bt, plan: RingPlan,
                  mesh: Mesh) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """A replicated; Bt padded to n*w rows and row-sharded (panel d on
    shard d). Each is a list over the owned shards."""
    pad = plan.n * plan.w - Bt.shape[0]
    Bt_p = np.pad(np.asarray(Bt), ((0, pad), (0, 0))) if pad else Bt
    return put_global(A, mesh), put_global(Bt_p, mesh, sharded=True)


def make_ring_sddmm(csr: CSR, reord: BsmrReordering, config: SddmmConfig,
                    mesh: Mesh, k: Optional[int] = None,
                    emit: str = "csr",
                    backend: Optional[str] = None
                    ) -> Tuple[Callable, RingPlan]:
    """Build the ring SDDMM: ``fn(A, Bt_sharded)`` on
    :func:`ring_operands`' lists.

    Each of the n steps computes, on every owned shard, the tile group
    for the B panel the shard holds, then rotates the panels one hop
    (n - 1 hops in all, never an all-gather). The kernels are enqueued
    asynchronously, so on several cards the shards run side by side.
    ``emit="rphm"`` returns ``(dense, gathered, residual)``, each a list
    over the owned shards of (n, Td, ph, bw), (n, Tg, ph, bw) and (n, E)
    arrays indexed by B panel; ``emit="csr"`` gathers them along
    ``plan.rphm_to_csr`` into (nnz,) values in CSR order, in every
    process. ``backend`` is the body's: ``"auto"`` runs the hand kernels
    on CUDA tensors, ``"torch"`` their plain versions.
    """
    if emit not in ("rphm", "csr"):
        raise ValueError(f"unknown emit {emit!r}")
    backend = config.backend if backend is None else backend
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    plain = backend == "torch"
    bsr_op = dk.bsr_dense_plain if plain else dk.bsr_dense
    tile_op = dk.dense_tile_plain if plain else dk.dense_tile
    passes, _ = precision_of(config.matmul_precision)
    n = mesh.size
    plan = pack_ring_plans(csr, reord, config, n, k=k)
    ph, bw, kk = plan.panel_height, plan.block_width, plan.k
    P_l = plan.panels_per_shard
    Tg = plan.tiles_g_per_group

    def up(arr, s, dev):
        return torch.from_numpy(np.ascontiguousarray(arr[s], np.int32)).to(
            dev)

    # each owned shard's (n_panels, ...) groups, on its device
    shards = [dict(row_perm=up(plan.row_perm, s, dev),
                   tile_rp=up(plan.tile_rpanel, s, dev),
                   tile_cb=up(plan.tile_cb, s, dev),
                   g_rp=up(plan.g_rpanel, s, dev),
                   g_cl=up(plan.g_cols_l, s, dev),
                   res_ar=up(plan.res_arow, s, dev),
                   res_cl=up(plan.res_col, s, dev))
              for s, dev in zip(mesh.owned, mesh.devices)]

    def step(sh, A_perm, A_panels, B_cur, p):
        dense = bsr_op(A_panels, B_cur, sh["tile_rp"][p], sh["tile_cb"][p],
                       fat_group=1, block_width=bw, passes=passes)
        gathered = (tile_op(A_panels, B_cur, sh["g_rp"][p], sh["g_cl"][p],
                            passes=passes) if Tg else None)
        a = A_perm.index_select(0, sh["res_ar"][p])
        b = B_cur.index_select(0, sh["res_cl"][p])
        return dense, gathered, (a * b).sum(-1)

    def rphm(A, Bt):
        A_perm = [a.to(torch.float32).index_select(0, sh["row_perm"])
                  for a, sh in zip(A, shards)]
        A_panels = [a.reshape(P_l, ph, kk) for a in A_perm]
        B_cur = [b.to(torch.float32).contiguous() for b in Bt]
        parts = [[None] * n for _ in shards]
        for i in range(n):
            for j, s in enumerate(mesh.owned):
                p = (s + i) % n
                parts[j][p] = step(shards[j], A_perm[j], A_panels[j],
                                   B_cur[j], p)
            if i < n - 1:
                B_cur = collectives.ring_shift(B_cur, mesh)
        dense = [torch.stack([d for d, _, _ in sp]) for sp in parts]
        gathered = [torch.stack([g for _, g, _ in sp]) if Tg else
                    d.new_empty((n, 0, ph, bw))
                    for sp, d in zip(parts, dense)]
        res = [torch.stack([r for _, _, r in sp]) for sp in parts]
        return dense, gathered, res

    if emit == "rphm":
        return rphm, plan

    csr_map = torch.from_numpy(plan.rphm_to_csr).to(mesh.devices[0])

    def fn(A, Bt):
        return collectives.csr_gather(rphm(A, Bt), csr_map, mesh)

    return fn, plan
