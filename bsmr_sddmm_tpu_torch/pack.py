"""TilePlan: pack a reordered mask into static-shaped tile buffers.

A copy of ``bsmr_sddmm_tpu.pack.pack_tiles`` and ``TilePlan`` (plain NumPy),
kept in this package because importing ``bsmr_sddmm_tpu`` imports JAX. The
same reordering gives a bit-identical ``TilePlan`` in both packages
(tests/test_torch_host.py), so the two bodies can be compared tier by tier.
The shard packing of the parallel layer (``pack_shard_plans``,
``panel_cost_weights``, ``_unify_window_groups``, ``_pad_plan_to``) is
copied too, so both packages split a mask into bit-identical shard plans
(tests/test_torch_parallel.py).

The plan re-designs the CUDA original's RPHM device format
(RPHM::RPHM, src/BSMR.cpp:83-265):

* The original's ``blockValues`` — one index into the CSR values per
  dense-tile slot, NULL for holes (BSMR.cpp:143-174) — becomes
  ``tile_scatter[t, i, j]``: an index into a length ``nnz+1`` output vector
  whose last slot is a trash slot. Kernels write whole tiles; placement in
  CSR order is one gather along ``rphm_to_csr``.
* The original's sparse-part COO triples (relative row, column, CSR index,
  BSMR.cpp:176-219) become three flat arrays, padded to a bucketed length;
  ``res_arow`` indexes directly into the row-permuted A so the residual
  path is two row gathers + a multiply-reduce.
* The original's per-thread-block work lists (BSMR.cpp:93-119) become the
  kernels' grids: one thread block per tile.

Everything is padded to static shapes; tile and residual counts round up to
a small set of buckets.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.reorder import BsmrReordering, _concat_ranges
from bsmr_sddmm_tpu_torch.utils import profiling


def bucket_size(n: int, enabled: bool = True, granule: int = 8) -> int:
    """Round ``n`` up to a bucketed size with <= 12.5% padding waste:
    the next multiple of max(granule, 2^floor(log2 n)/8)."""
    if n <= 0:
        return granule
    if not enabled:
        return max(n, 1)
    step = max(granule, 1 << max(0, n.bit_length() - 4))
    return -(-n // step) * step


def exec_size(n: int, enabled: bool, chunk: int, granule: int = 8) -> int:
    """Bucket ``n`` AND round up to an exact execution-chunk multiple.

    The JAX package's body processes arrays in ``chunk``-sized pieces;
    exact multiples make every chunk slice a no-op there. Kept so that
    plans match the reference's."""
    b = bucket_size(n, enabled, granule)
    c = min(max(chunk, granule), b)
    return -(-b // c) * c


@dataclasses.dataclass
class TilePlan:
    """Static-shaped packing of one (matrix, alpha, delta) configuration."""

    # geometry
    rows: int
    cols: int
    nnz: int
    k: int
    panel_height: int
    block_width: int
    num_panels: int

    # dense part (T tiles after bucket padding, T0 real)
    num_tiles: int                 # T0
    tile_panel: np.ndarray         # (T,) int32, panel id (pad: 0)
    tile_cols: np.ndarray          # (T, bw) int32, col ids clipped to [0, N-1]
    tile_scatter: np.ndarray       # (T, ph, bw) int32 into [0, nnz]

    # sub-block packed tiles (Tp after padding, Tp0 real): S qualifying
    # sw-wide aligned column sub-blocks of one panel per 128-lane tile;
    # the B operand is S contiguous (sw, K) block slices of Bt2. The
    # executed output is its own array (rphm layout: dense, packed,
    # gathered, residual).
    num_packed: int = 0            # Tp0
    sp_panel: np.ndarray = None    # (Tp,) int32, panel id (pad: 0)
    sp_sub: np.ndarray = None      # (Tp, S) int32 sub-block ids into Bt2
    sp_scatter: np.ndarray = None  # (Tp, ph, bw) int32 into [0, nnz]
    sp_colperm: np.ndarray = None  # (H,) int32 hot-column permutation:
    #                                Bt2 = take(Bt, sp_colperm), packed
    #                                tiles read (sw, K) slices of Bt2
    subblock_width: int = 0        # sw (0 = tier absent)

    # gathered tiles (Tg after bucket padding, Tg0 real): residual columns
    # of one panel packed 128-wide; the B operand is a take()-gather
    num_gathered: int = 0          # Tg0
    g_panel: np.ndarray = None     # (Tg,) int32, panel id (pad: 0)
    g_cols: np.ndarray = None      # (Tg, bw) int32 clipped to [0, N-1]
    g_scatter: np.ndarray = None   # (Tg, ph, bw) int32 into [0, nnz]

    # per-nonzero residual (E entries after bucket padding, E0 real)
    num_residual: int = 0          # E0
    res_arow: np.ndarray = None    # (E,) int32 into A_perm rows (pad: 0)
    res_col: np.ndarray = None     # (E,) int32 (pad: 0)
    res_out: np.ndarray = None     # (E,) int32 into [0, nnz]

    # row permutation padded to num_panels * panel_height (pad: 0)
    row_perm_padded: np.ndarray = None   # (num_panels*ph,) int32

    # inverse of the scatter maps: for CSR value index i,
    # rphm_to_csr[i] is its offset in concat(dense_out.ravel(),
    # gathered_out.ravel(), res_vals) — CSR emission is then ONE gather
    # (scattering every padded tile slot would touch mostly trash slots)
    rphm_to_csr: np.ndarray = None       # (nnz,) int32

    pack_time_ms: float = 0.0
    # the delta this plan was packed with (from the column split)
    delta_used: float = float("nan")
    # column mode: "bsr" tiles are natural column blocks (tile_cblock valid,
    # B reads contiguous); "reorder" tiles gather tile_cols per tile
    mode: str = "bsr"
    tile_cblock: Optional[np.ndarray] = None   # (T,) int32, bsr mode only
    # fat steps (bsr mode): G same-cblock tiles per grid step; tile arrays
    # stay flat (T = n_steps * G) and step_cblock holds one cblock per step
    fat_group: int = 1
    step_cblock: Optional[np.ndarray] = None   # (T // fat_group,) int32

    # B-gather windowing (host metadata, see SddmmConfig.gather_window_mb):
    # when set, real gathered tiles / residual entries are sorted by column
    # window and each (base_row, start, end) group gathers from the static
    # window slice Bt[base : base + window_rows]. None = unwindowed.
    window_rows: Optional[int] = None      # B-side window (rows of Bt)
    a_window_rows: Optional[int] = None    # A-side window (rows of A_perm)
    g_groups: Optional[list] = None    # [(b_base, tile_start, tile_end)]
    res_groups: Optional[list] = None  # [(a_base, b_base, start, end)],
    #                                     base -1 = that side unwindowed

    # --- statistics (reference evaluationReordering, BSMR.cpp:826-930) ---
    @property
    def dense_nnz(self) -> int:
        """Nonzeros covered by dense (BSR/reordered) tiles."""
        return int((self.tile_scatter < self.nnz).sum())

    @property
    def packed_nnz(self) -> int:
        """Nonzeros covered by sub-block packed tiles."""
        if self.sp_scatter is None or not self.sp_scatter.size:
            return 0
        return int((self.sp_scatter < self.nnz).sum())

    @property
    def gathered_nnz(self) -> int:
        """Nonzeros covered by gathered-column tiles."""
        if self.g_scatter is None:
            return 0
        return int((self.g_scatter < self.nnz).sum())

    @property
    def residual_nnz(self) -> int:
        return self.num_residual

    @property
    def average_tile_density(self) -> float:
        """Fill of the matmul-tile tiers (dense BSR + packed), the
        reference's averageDensity statistic (BSMR.cpp:334-442)."""
        slots = ((self.num_tiles + self.num_packed)
                 * self.panel_height * self.block_width)
        if slots == 0:
            return 0.0
        return (self.dense_nnz + self.packed_nnz) / slots

    def csr_values_from_rphm(self, dense_out: np.ndarray,
                             packed_out: np.ndarray,
                             gathered_out: np.ndarray,
                             res_vals: np.ndarray) -> np.ndarray:
        """Host-side assembly of CSR-order values from the four-tier
        rphm-layout outputs (the static bijection recorded in
        tile_scatter/sp_scatter/g_scatter/res_out)."""
        P = np.empty(self.nnz + 1, dtype=np.float32)
        P[self.tile_scatter.reshape(-1)] = \
            np.asarray(dense_out).reshape(-1)
        if self.sp_scatter is not None and self.sp_scatter.size:
            P[self.sp_scatter.reshape(-1)] = \
                np.asarray(packed_out).reshape(-1)
        if self.g_scatter is not None and self.g_scatter.size:
            P[self.g_scatter.reshape(-1)] = \
                np.asarray(gathered_out).reshape(-1)
        P[self.res_out] = np.asarray(res_vals)
        return P[:self.nnz]

    def flops(self) -> dict:
        """Raw device flops vs useful flops (2*nnz*K is the benchmark
        numerator, include/Logger.hpp:178-180)."""
        tile_flops = 2 * self.panel_height * self.block_width * self.k
        return {
            "useful": 2 * self.nnz * self.k,
            "dense_raw": self.num_tiles * tile_flops,
            "packed_raw": self.num_packed * tile_flops,
            "gathered_raw": self.num_gathered * tile_flops,
            "residual_raw": 2 * self.num_residual * self.k,
        }


def pack_tiles(csr: CSR, reord: BsmrReordering, config: SddmmConfig,
               k: Optional[int] = None,
               fat_group_override: Optional[int] = None) -> TilePlan:
    """Build the TilePlan from a finished BSMR reordering.

    Mirrors RPHM::RPHM's two passes (dense blockValues, BSMR.cpp:143-174;
    sparse COO, BSMR.cpp:176-219) as one vectorized dense-membership join:
    every CSR entry looks up (panel, col) in the panel's dense column list;
    hits land in ``tile_scatter``, misses become residual entries.

    Recorded as the span ``prep.pack`` with one child per phase:
    ``.join`` (entries in reordered order, the dense membership join),
    ``.layout`` (tile order and fat steps), ``.scatter`` (the dense scatter
    map and the inverse map), ``.packed`` (the residual's entries and the
    hot-column packed tier), ``.gathered`` (gathered tiles and the
    per-nonzero tail), ``.windows`` (gather windows and the residual's
    inverse map) and ``.rows`` (the padded row permutation and the plan);
    ``pack_time_ms`` is the span's duration.
    """
    with profiling.span("prep.pack") as prep:
        plan = _pack_tiles(csr, reord, config, k, fat_group_override, prep)
    plan.pack_time_ms = prep.duration_ms
    return plan


def _pack_tiles(csr: CSR, reord: BsmrReordering, config: SddmmConfig,
                k: Optional[int], fat_group_override: Optional[int],
                prep: profiling.Span) -> TilePlan:
    prep.phase("join")
    if reord.dense_cols is None:
        raise ValueError("run the column split (split_columns) first")
    k = config.k if k is None else k
    ph, bw = config.panel_height, config.block_width
    perm = reord.row_perm.astype(np.int64)
    R = perm.shape[0]
    num_panels = reord.num_row_panels
    N = csr.cols
    nnz = csr.nnz

    dense_cols = reord.dense_cols
    dco = reord.dense_col_offsets
    num_tiles0 = int(dco[-1]) // bw

    # --- enumerate CSR entries in reordered order ------------------------
    row_nnz = csr.row_nnz()
    perm_nnz = row_nnz[perm]
    pos_in_perm = np.repeat(np.arange(R, dtype=np.int64), perm_nnz)
    panel_of_entry = pos_in_perm // ph
    entry_idx = _concat_ranges(csr.row_offsets[perm], perm_nnz)  # CSR index
    cols_of_entry = csr.col_indices[entry_idx].astype(np.int64)

    # --- dense membership join -------------------------------------------
    # key = panel * (N+1) + col; sentinel pad columns (col == N) get keys
    # that no entry can produce.
    sent = np.int64(N + 1)
    panel_of_densecol = np.repeat(np.arange(num_panels, dtype=np.int64),
                                  np.diff(dco))
    dense_keys = panel_of_densecol * sent + dense_cols
    dense_sort = np.argsort(dense_keys, kind="stable")
    dense_keys_sorted = dense_keys[dense_sort]
    entry_keys = panel_of_entry * sent + cols_of_entry
    pos = np.searchsorted(dense_keys_sorted, entry_keys)
    pos_clipped = np.minimum(pos, max(dense_keys_sorted.shape[0] - 1, 0))
    if dense_keys_sorted.shape[0]:
        is_dense = dense_keys_sorted[pos_clipped] == entry_keys
    else:
        is_dense = np.zeros(entry_keys.shape[0], dtype=bool)

    # --- dense tile layout: ordering + fat steps BEFORE the map -----------
    prep.phase("layout")
    # The final tile layout — the (cblock, panel) sort that lets
    # consecutive tiles reuse one B block, plus fat-step run padding — is
    # computed
    # on per-TILE arrays first, so entries scatter directly into their
    # final slots: one pass over the (T, ph, bw) map.
    mode = config.col_mode
    if num_tiles0:
        tile_panel0 = np.repeat(np.arange(num_panels, dtype=np.int32),
                                np.diff(dco) // bw)
        # clip sentinel pad columns for gather safety; their scatter slots
        # stay at the trash index so the garbage never lands
        tile_cols0 = np.minimum(dense_cols.reshape(num_tiles0, bw),
                                N - 1).astype(np.int32)
    else:
        tile_panel0 = np.zeros(0, np.int32)
        tile_cols0 = np.zeros((0, bw), np.int32)
    fat_group = 1
    step_cblock = None
    tile_cblock = None
    if mode == "bsr":
        cblock0 = (tile_cols0[:, 0] // bw).astype(np.int32)
        # sort tiles by (cblock, panel): consecutive tiles with the same
        # cblock can then reuse one resident B block
        order = (np.lexsort((tile_panel0, cblock0))
                 if num_tiles0 > 1 else
                 np.arange(num_tiles0, dtype=np.int64))
        cb_sorted = cblock0[order]
        # fat steps: G same-cblock tiles per step share one B block. Each
        # same-cblock run pads to a G multiple; G adapts to the run
        # structure so padding stays small.
        want_fat = (fat_group_override if fat_group_override is not None
                    else config.dense_fat_group)
        G = 1
        if want_fat > 1 and num_tiles0:
            run_starts = np.nonzero(np.diff(cb_sorted, prepend=-1))[0]
            run_lens = np.diff(np.append(run_starts, num_tiles0))
            if fat_group_override is not None:
                # shard packs force one G across shards (the sharded body
                # is built once, from the first shard's plan)
                G = fat_group_override
            else:
                # choose G by minimizing padded tiles x per-tile cost:
                # fatter steps amortize a per-step cost but pad each
                # same-cblock run up to a G multiple. The weights are the
                # JAX package's, fitted on its TPU and kept unchanged so
                # that plans stay bit-identical; costs for this package's
                # kernels are later work (ROADMAP.md).
                best_score = None
                g_cand = 1
                while g_cand <= want_fat:
                    padded = int((-(-run_lens // g_cand) * g_cand).sum())
                    score = padded * (52.0 + 208.0 / g_cand)
                    if best_score is None or score < best_score:
                        best_score, G = score, g_cand
                    g_cand *= 2
        if G > 1:
            padded_lens = -(-run_lens // G) * G
            T_flat0 = int(padded_lens.sum())
            n_steps = exec_size(T_flat0 // G, config.bucket_shapes,
                                config.dense_chunk)
            T = n_steps * G
            run_dst = np.zeros(run_starts.shape[0], np.int64)
            np.cumsum(padded_lens[:-1], out=run_dst[1:])
            dst = _concat_ranges(run_dst, run_lens)
            tile_cblock = np.zeros(T, np.int32)
            tile_cblock[:T_flat0] = np.repeat(cb_sorted[run_starts],
                                              padded_lens)
            tile_panel = np.zeros(T, np.int32)
            tile_panel[dst] = tile_panel0[order]
            # pad tiles read their run's (or block 0's) columns; their
            # scatter slots are trash so the values never land
            tile_cols = np.minimum(
                tile_cblock[:, None].astype(np.int64) * bw
                + np.arange(bw), N - 1).astype(np.int32)
            tile_cols[dst] = tile_cols0[order]
            step_cblock = tile_cblock.reshape(n_steps, G)[:, 0].copy()
            fat_group = G
            final_of_sorted = dst
        else:
            T = exec_size(num_tiles0, config.bucket_shapes,
                          config.dense_chunk)
            tile_panel = np.zeros(T, np.int32)
            tile_panel[:num_tiles0] = tile_panel0[order]
            tile_cols = np.zeros((T, bw), np.int32)
            tile_cols[:num_tiles0] = tile_cols0[order]
            tile_cblock = np.zeros(T, np.int32)
            tile_cblock[:num_tiles0] = cb_sorted
            final_of_sorted = np.arange(num_tiles0, dtype=np.int64)
        final_of_orig = np.empty(num_tiles0, np.int64)
        final_of_orig[order] = final_of_sorted
    else:
        # reorder tiles keep panel order; each gathers its own tile_cols
        T = exec_size(num_tiles0, config.bucket_shapes, config.dense_chunk)
        tile_panel = np.zeros(T, dtype=np.int32)
        tile_panel[:num_tiles0] = tile_panel0
        tile_cols = np.zeros((T, bw), dtype=np.int32)
        tile_cols[:num_tiles0] = tile_cols0
        final_of_orig = np.arange(num_tiles0, dtype=np.int64)

    # --- dense scatter map + inverse map, one pass -------------------------
    prep.phase("scatter")
    # rphm_to_csr (rphm layout -> CSR order) is built tier by tier from
    # each entry's destination slot as it scatters; the executed layout is
    # [dense BSR tiles | packed sub-block tiles | gathered tiles |
    # residual]. (The previous version re-derived it afterwards by
    # scanning every slot of every padded map — three more full passes.)
    assert T * ph * bw < np.iinfo(np.int32).max
    rphm_to_csr = np.zeros(nnz, dtype=np.int32)
    tile_scatter = np.full((T, ph, bw), nnz, dtype=np.int32)
    if is_dense.any():
        hit_positions = dense_sort[pos_clipped[is_dense]]  # into dense_cols
        hit_panels = panel_of_entry[is_dense]
        within_panel = hit_positions - dco[hit_panels]
        tile_of_hit = final_of_orig[(dco[hit_panels] // bw)
                                    + within_panel // bw]
        local_col = within_panel % bw
        local_row = pos_in_perm[is_dense] % ph
        e_dense = entry_idx[is_dense]
        tile_scatter[tile_of_hit, local_row, local_col] = \
            e_dense.astype(np.int32)
        rphm_to_csr[e_dense] = (tile_of_hit * (ph * bw) + local_row * bw
                                + local_col).astype(np.int32)

    # --- residual: gathered tiles + per-nnz tail ---------------------------
    prep.phase("packed")
    # Residual entries are split a second time (the CUDA original has no
    # analogue): per panel, residual columns are sorted by in-panel count
    # descending and packed into bw-wide *gathered* tiles as long as a tile
    # covers >= residual_tile_min_nnz nonzeros — above that, one B-row
    # gather per column + a tile matmul moves fewer bytes than per-nonzero
    # row gathers. The tail stays per-nonzero COO.
    res_mask = ~is_dense
    r_panel = panel_of_entry[res_mask]
    r_col = cols_of_entry[res_mask]
    r_lrow = (pos_in_perm[res_mask] % ph).astype(np.int64)
    r_arow = pos_in_perm[res_mask]
    r_csr = entry_idx[res_mask]

    # --- hot-column packed tier (the tile-fill lever) ---------------------
    # Residual columns are PERMUTED — ordered by (dominant panel, count
    # desc), so columns hot in the same row panels become adjacent — and
    # sw-wide sub-blocks of the permuted space with >= subpack_min_nnz
    # in-panel entries pack S = bw/sw per tile. Execution materializes
    # Bt2 = Bt[colperm] ONCE per call, after which every packed tile's B
    # operand is S contiguous (sw, K) slices of Bt2 — one amortized gather
    # instead of a per-tile row gather. This is the CUDA original's
    # count-descending colReordering (colReordering.cu:274-404 + the
    # 16-wide gathered dense columns at 244-271) re-created for tiles.
    sw = config.subblock_width
    S = (bw // sw) if sw else 0
    num_packed0 = 0
    sp_panel = np.zeros(0, np.int32)
    sp_sub = np.zeros((0, max(S, 1)), np.int32)
    sp_scatter = np.zeros((0, ph, bw), np.int32)
    sp_colperm = np.zeros(0, np.int32)
    if config.subpack_min_nnz and S and r_panel.shape[0]:
        # unique (panel, col) pairs with counts
        pc_key = r_panel * sent + r_col
        pc_order = np.argsort(pc_key, kind="stable")
        pcs = pc_key[pc_order]
        pc_pos = np.nonzero(np.diff(pcs, prepend=-1))[0]
        u_key = pcs[pc_pos]
        u_cnt = np.diff(np.append(pc_pos, pcs.shape[0]))
        u_panel = u_key // sent
        u_col = u_key % sent
        # per column: total count + dominant panel (panel with max count)
        col_order = np.lexsort((-u_cnt, u_col))
        c_panel = u_panel[col_order]
        c_col = u_col[col_order]
        c_cnt = u_cnt[col_order]
        cstarts = np.nonzero(np.diff(c_col, prepend=-1))[0]
        ucols = c_col[cstarts]                 # unique cols, ascending
        dom_panel = c_panel[cstarts]           # first in group = max count
        tot = np.add.reduceat(c_cnt, cstarts)
        # permuted order: (dominant panel, count desc, col)
        perm_order = np.lexsort((ucols, -tot, dom_panel))
        H0 = ucols.shape[0]
        H = -(-H0 // sw) * sw
        sp_colperm = np.zeros(H, np.int32)
        sp_colperm[:H0] = np.minimum(ucols[perm_order],
                                     N - 1).astype(np.int32)
        sp_colperm[H0:] = sp_colperm[max(H0 - 1, 0)]   # pad: repeat last
        # permuted position of each entry's column
        pos_of_ucol = np.empty(H0, np.int64)
        pos_of_ucol[perm_order] = np.arange(H0)
        e_pos = pos_of_ucol[np.searchsorted(ucols, r_col)]
        # (panel, permuted sub-block) membership
        n_sb = H // sw
        ent_key = r_panel * np.int64(n_sb) + e_pos // sw
        sp_order = np.argsort(ent_key, kind="stable")
        ks = ent_key[sp_order]
        uq_pos = np.nonzero(np.diff(ks, prepend=-1))[0]
        uq_key = ks[uq_pos]                        # ascending
        uq_cnt = np.diff(np.append(uq_pos, ks.shape[0]))
        qual = uq_cnt >= config.subpack_min_nnz
        n_qual = int(qual.sum())
        if n_qual:
            q_key = uq_key[qual]
            q_panel = q_key // n_sb
            q_sb = (q_key % n_sb).astype(np.int64)
            # group by panel, S sub-blocks per tile
            pstarts = np.nonzero(np.diff(q_panel, prepend=-1))[0]
            plens = np.diff(np.append(pstarts, n_qual))
            pidx_of_q = np.searchsorted(pstarts, np.arange(n_qual),
                                        side="right") - 1
            within = np.arange(n_qual) - pstarts[pidx_of_q]
            tiles_per_panel = -(-plens // S)
            tile_base = np.zeros(pstarts.shape[0], np.int64)
            np.cumsum(tiles_per_panel[:-1], out=tile_base[1:])
            tile_of_q = tile_base[pidx_of_q] + within // S
            slot_of_q = within % S
            num_packed0 = int(tiles_per_panel.sum())
            Tp = exec_size(num_packed0, config.bucket_shapes,
                           config.dense_chunk)
            sp_panel = np.zeros(Tp, np.int32)
            sp_panel[:num_packed0] = np.repeat(
                q_panel[pstarts], tiles_per_panel).astype(np.int32)
            sp_sub = np.full((Tp, S), -1, np.int32)
            sp_sub[tile_of_q, slot_of_q] = q_sb.astype(np.int32)
            # pad slots read the tile's first sub-block (slot 0 is always
            # real); pad tiles read sub-block 0 — their scatter is trash
            first = np.where(sp_sub[:, 0] >= 0, sp_sub[:, 0], 0)
            sp_sub = np.where(sp_sub >= 0, sp_sub,
                              first[:, None]).astype(np.int32)
            # route entries into tiles
            ent_uq = np.searchsorted(uq_key, ent_key)
            in_packed_s = qual[ent_uq]             # aligned with r_*!
            tile_of_uq = np.full(uq_key.shape[0], 0, np.int64)
            slot_of_uq = np.zeros(uq_key.shape[0], np.int64)
            tile_of_uq[qual] = tile_of_q
            slot_of_uq[qual] = slot_of_q
            assert (T + Tp) * ph * bw < np.iinfo(np.int32).max
            sp_scatter = np.full((Tp, ph, bw), nnz, np.int32)
            pe = in_packed_s
            _sp_slot = (tile_of_uq[ent_uq[pe]] * (ph * bw)
                        + r_lrow[pe] * bw
                        + slot_of_uq[ent_uq[pe]] * sw + e_pos[pe] % sw)
            sp_scatter[tile_of_uq[ent_uq[pe]], r_lrow[pe],
                       slot_of_uq[ent_uq[pe]] * sw + e_pos[pe] % sw] = \
                r_csr[pe].astype(np.int32)
            rphm_to_csr[r_csr[pe]] = \
                (T * (ph * bw) + _sp_slot).astype(np.int32)
            # remaining residual entries flow to the gathered/per-nnz
            # tiers below
            keep = ~pe
            r_panel, r_col, r_lrow, r_arow, r_csr = (
                r_panel[keep], r_col[keep], r_lrow[keep],
                r_arow[keep], r_csr[keep])
        if num_packed0 == 0:
            sp_colperm = np.zeros(0, np.int32)
        else:
            # trim the permutation to the sub-blocks actually referenced
            # (every row of it is gathered once per call)
            max_sb = int(sp_sub.max()) + 1
            if max_sb * sw < H:
                sp_colperm = sp_colperm[:max_sb * sw]

    num_gathered0 = 0
    g_panel = np.zeros(0, np.int32)
    g_cols = np.zeros((0, bw), np.int32)
    g_scatter = np.zeros((0, ph, bw), np.int32)
    in_gathered = np.zeros(r_panel.shape[0], dtype=bool)

    prep.phase("gathered")
    # B-gather windowing (the JAX package's gather cliff): decide the window size
    # up front — gathered tiles must be *window-pure* (every column of a
    # tile inside one window) so execution can gather from a static slice.
    window_rows = None
    if (config.gather_window_mb
            and N * k * 4 > (config.gather_window_threshold_mb << 20)):
        wr = max((config.gather_window_mb << 20) // (k * 4), bw)
        # bound the number of windows (each becomes its own unrolled
        # slice+gather+matmul group in the program)
        wr = max(wr, -(-N // max(config.max_gather_groups, 1)))
        if N > 2 * wr:
            window_rows = wr

    if config.residual_mode == "gathered" and r_panel.shape[0]:
        # unique (panel, col) with counts
        rk = r_panel * sent + r_col
        rk_order = np.argsort(rk, kind="stable")
        rk_sorted = rk[rk_order]
        uq_pos = np.nonzero(np.diff(rk_sorted, prepend=-1))[0]
        uq_keys = rk_sorted[uq_pos]
        uq_counts = np.diff(np.append(uq_pos, rk_sorted.shape[0]))
        uq_panel = uq_keys // sent
        uq_col = uq_keys % sent
        # per (panel [, window]): count desc, col asc on ties
        uq_wg = (uq_col // window_rows if window_rows
                 else np.zeros_like(uq_col))
        srt = np.lexsort((uq_col, -uq_counts, uq_wg, uq_panel))
        uq_panel, uq_col, uq_counts, uq_wg = \
            uq_panel[srt], uq_col[srt], uq_counts[srt], uq_wg[srt]
        # chunk into bw-wide groups per (panel, window) segment
        U = uq_panel.shape[0]
        n_wg = (N // window_rows + 1) if window_rows else 1
        gid = uq_panel * n_wg + uq_wg
        seg_start_pos = np.nonzero(np.diff(gid, prepend=-1))[0]
        seg_of_col = np.searchsorted(seg_start_pos, np.arange(U),
                                     side="right") - 1
        within = np.arange(U) - seg_start_pos[seg_of_col]
        chunk_of_col = within // bw          # per-segment chunk index
        ckey = seg_of_col.astype(np.int64) * np.int64(U + 1) + chunk_of_col
        cpos = np.nonzero(np.diff(ckey, prepend=-1))[0]
        chunk_nnz = np.add.reduceat(uq_counts, cpos) \
            if cpos.size else np.zeros(0, np.int64)
        keep_chunk = chunk_nnz >= config.residual_tile_min_nnz
        # chunk index per unique col (chunks enumerate in sorted order)
        col_chunk = np.searchsorted(cpos, np.arange(uq_panel.shape[0]),
                                    side="right") - 1
        col_kept = keep_chunk[col_chunk]
        kept_chunks = np.nonzero(keep_chunk)[0]
        num_gathered0 = kept_chunks.shape[0]
        if num_gathered0:
            # global gathered-tile id per kept chunk. Window ordering is
            # folded in here (tiles sorted by B window) so the map never
            # needs a post-scatter reorder; the group ranges are derived
            # from the same sorted keys below.
            tile_of_chunk = np.full(keep_chunk.shape[0], -1, np.int64)
            first_col = np.minimum(uq_col[cpos[kept_chunks]], N - 1)
            if window_rows:
                _g_grp = first_col // window_rows
                _g_worder = np.argsort(_g_grp, kind="stable")
                _g_rank = np.empty(num_gathered0, np.int64)
                _g_rank[_g_worder] = np.arange(num_gathered0)
                tile_of_chunk[kept_chunks] = _g_rank
                _g_grp_sorted = _g_grp[_g_worder]
            else:
                tile_of_chunk[kept_chunks] = np.arange(num_gathered0)
            Tg = exec_size(num_gathered0, config.bucket_shapes,
                           config.dense_chunk)
            g_panel = np.zeros(Tg, np.int32)
            g_panel[tile_of_chunk[kept_chunks]] = \
                uq_panel[cpos[kept_chunks]].astype(np.int32)
            g_cols_full = np.full((Tg, bw), -1, np.int32)
            g_scatter = np.full((Tg, ph, bw), nnz, dtype=np.int32)
            # local col slot within the chunk
            local_slot = (within % bw).astype(np.int64)
            kept_cols = np.nonzero(col_kept)[0]
            g_cols_full[tile_of_chunk[col_chunk[kept_cols]],
                        local_slot[kept_cols]] = \
                np.minimum(uq_col[kept_cols], N - 1).astype(np.int32)
            # pad slots point at the tile's first column (keeps tiles
            # window-pure; their scatter slots are trash anyway)
            firstcol = np.where(g_cols_full[:, 0] >= 0,
                                g_cols_full[:, 0], 0)
            g_cols_full = np.where(g_cols_full >= 0, g_cols_full,
                                   firstcol[:, None]).astype(np.int32)
            g_cols = g_cols_full
            # route entries: entry key -> index into the (panel, -count)
            # sorted unique arrays, via an argsort of the unique keys
            uq_resort = np.argsort(uq_panel * sent + uq_col, kind="stable")
            uq_keys_sorted2 = (uq_panel * sent + uq_col)[uq_resort]
            pos2 = np.searchsorted(uq_keys_sorted2, rk)
            ent_uqidx = uq_resort[pos2]
            ent_kept = col_kept[ent_uqidx]
            in_gathered = ent_kept
            tgt_tile = tile_of_chunk[col_chunk[ent_uqidx[ent_kept]]]
            tgt_slot = local_slot[ent_uqidx[ent_kept]]
            assert (T + sp_scatter.shape[0] + Tg) * ph * bw \
                < np.iinfo(np.int32).max
            g_scatter[tgt_tile, r_lrow[ent_kept], tgt_slot] = \
                r_csr[ent_kept].astype(np.int32)
            rphm_to_csr[r_csr[ent_kept]] = (
                (T + sp_scatter.shape[0]) * (ph * bw)
                + tgt_tile * (ph * bw) + r_lrow[ent_kept] * bw
                + tgt_slot).astype(np.int32)
        else:
            g_cols = np.zeros((0, bw), np.int32)
            g_scatter = np.zeros((0, ph, bw), np.int32)
            g_panel = np.zeros(0, np.int32)

    # Tg padding floor: keep at least one (trash) tile so device shapes are
    # never zero-sized
    if g_panel.shape[0] == 0:
        Tg = exec_size(0, config.bucket_shapes, config.dense_chunk)
        g_panel = np.zeros(Tg, np.int32)
        g_cols = np.full((Tg, bw), max(N - 1, 0), np.int32)
        g_scatter = np.full((Tg, ph, bw), nnz, dtype=np.int32)

    tail = ~in_gathered
    num_residual0 = int(tail.sum())
    E = exec_size(num_residual0, config.bucket_shapes,
                  config.residual_chunk)
    res_arow = np.zeros(E, dtype=np.int32)
    res_col = np.zeros(E, dtype=np.int32)
    res_out = np.full(E, nnz, dtype=np.int32)
    if num_residual0:
        res_arow[:num_residual0] = r_arow[tail]
        res_col[:num_residual0] = r_col[tail]
        res_out[:num_residual0] = r_csr[tail].astype(np.int32)

    # --- gather windowing: group metadata ------------------------------------
    prep.phase("windows")
    # Sort real gathered tiles by column window and record static
    # (base, start, end) groups; execution gathers each group from the
    # window slice Bt[base : base + window_rows]. The per-nnz tail windows
    # BOTH operands when big: entries sort by (A-window, B-window) pair and
    # res_groups carries (a_base, b_base, start, end) with base -1 meaning
    # "that side unwindowed".
    g_groups = None
    res_groups = None
    a_rows = num_panels * ph
    a_window_rows = None
    if (config.gather_window_mb
            and a_rows * k * 4 > (config.gather_window_threshold_mb << 20)):
        awr = max((config.gather_window_mb << 20) // (k * 4), ph)
        awr = max(awr, -(-a_rows // max(config.max_gather_groups, 1)))
        if a_rows > 2 * awr:
            a_window_rows = awr

    if window_rows and num_gathered0:
        # tiles were built window-sorted in the gathered section (the
        # ordering is folded into tile_of_chunk), so only the static
        # group ranges remain to derive here — no map reorder
        gsorted = _g_grp_sorted
        starts = np.nonzero(np.diff(gsorted, prepend=-1))[0]
        ends = np.append(starts[1:], num_gathered0)
        g_groups = [(int(min(g * window_rows, N - window_rows)),
                     int(s), int(e))
                    for g, s, e in zip(gsorted[starts], starts, ends)]

    if (window_rows or a_window_rows) and num_residual0:
        a_grp = (res_arow[:num_residual0].astype(np.int64) // a_window_rows
                 if a_window_rows else
                 np.zeros(num_residual0, np.int64))
        b_grp = (res_col[:num_residual0].astype(np.int64) // window_rows
                 if window_rows else np.zeros(num_residual0, np.int64))
        # residual groups are (A-window, B-window) PAIRS; if the cross
        # product explodes past the op-count budget, drop the A-side
        # windowing (B-side matters more: B is the bigger gather operand)
        n_pairs = np.unique(a_grp * (int(b_grp.max()) + 1) + b_grp).size
        if n_pairs > 2 * max(config.max_gather_groups, 1):
            a_window_rows = None
            a_grp = np.zeros(num_residual0, np.int64)
        nbg = int(b_grp.max()) + 1 if num_residual0 else 1
        key = a_grp * nbg + b_grp
        order = np.argsort(key, kind="stable")
        ks = key[order]
        starts = np.nonzero(np.diff(ks, prepend=-1))[0]
        ends = np.append(starts[1:], num_residual0)
        res_groups = []
        for kk, s, e in zip(ks[starts], starts, ends):
            ag, bg = int(kk) // nbg, int(kk) % nbg
            a_base = (int(min(ag * a_window_rows, a_rows - a_window_rows))
                      if a_window_rows else -1)
            b_base = (int(min(bg * window_rows, N - window_rows))
                      if window_rows else -1)
            res_groups.append((a_base, b_base, int(s), int(e)))
        res_arow[:num_residual0] = res_arow[:num_residual0][order]
        res_col[:num_residual0] = res_col[:num_residual0][order]
        res_out[:num_residual0] = res_out[:num_residual0][order]

    if num_residual0:
        # residual inverse-map entries (written after the window reorder
        # above fixes final positions)
        _res_base = (tile_scatter.shape[0] + sp_scatter.shape[0]
                     + g_scatter.shape[0]) * (ph * bw)
        assert _res_base + E < np.iinfo(np.int32).max
        rphm_to_csr[res_out[:num_residual0]] = (
            _res_base + np.arange(num_residual0)).astype(np.int32)

    # --- padded row permutation --------------------------------------------
    prep.phase("rows")
    row_perm_padded = np.zeros(num_panels * ph, dtype=np.int32)
    row_perm_padded[:R] = perm


    plan = TilePlan(
        rows=csr.rows, cols=N, nnz=nnz, k=k,
        panel_height=ph, block_width=bw, num_panels=num_panels,
        num_tiles=num_tiles0,
        tile_panel=tile_panel, tile_cols=tile_cols,
        tile_scatter=tile_scatter,
        num_packed=num_packed0,
        sp_panel=sp_panel, sp_sub=sp_sub, sp_scatter=sp_scatter,
        sp_colperm=sp_colperm,
        subblock_width=sw if num_packed0 or (config.subpack_min_nnz and S)
        else 0,
        num_gathered=num_gathered0,
        g_panel=g_panel, g_cols=g_cols, g_scatter=g_scatter,
        num_residual=num_residual0,
        res_arow=res_arow, res_col=res_col, res_out=res_out,
        row_perm_padded=row_perm_padded,
        rphm_to_csr=rphm_to_csr,
        delta_used=float(reord.delta),
        mode=mode, tile_cblock=tile_cblock,
        fat_group=fat_group, step_cblock=step_cblock,
        window_rows=window_rows, a_window_rows=a_window_rows,
        g_groups=g_groups, res_groups=res_groups,
    )
    return plan


def _pad_plan_to(plan: TilePlan, T: int, Tp: int, Tg: int, E: int,
                 num_panels: int, H_cp: int = 0) -> TilePlan:
    """Pad a shard's TilePlan out to common shapes (extra tiles/entries
    land in the trash slot; extra panels read row 0 of A, never emitted;
    extra colperm rows gather column 0, referenced only by pad tiles)."""
    ph, bw, nnz = plan.panel_height, plan.block_width, plan.nnz
    G = plan.fat_group

    def pad(arr, n, fill):
        if arr.shape[0] == n:
            return arr
        extra = np.full((n - arr.shape[0],) + arr.shape[1:], fill,
                        arr.dtype)
        return np.concatenate([arr, extra], axis=0)

    T0 = plan.tile_panel.shape[0]
    assert T % max(G, 1) == 0 and T0 % max(G, 1) == 0
    ncb = -(-plan.cols // bw)
    pad_cols = np.minimum(np.arange(bw), plan.cols - 1).astype(np.int32)
    out = dataclasses.replace(
        plan,
        tile_panel=pad(plan.tile_panel, T, 0),
        tile_cols=pad(plan.tile_cols, T, 0) if T == T0 else np.concatenate(
            [plan.tile_cols, np.broadcast_to(pad_cols, (T - T0, bw)).copy()],
            axis=0),
        tile_scatter=pad(plan.tile_scatter, T, nnz),
        tile_cblock=(pad(plan.tile_cblock, T, 0)
                     if plan.tile_cblock is not None else None),
        step_cblock=(pad(plan.step_cblock, T // G, 0)
                     if plan.step_cblock is not None else None),
        sp_panel=pad(plan.sp_panel, Tp, 0),
        sp_sub=pad(plan.sp_sub, Tp, 0),
        sp_scatter=pad(plan.sp_scatter, Tp, nnz),
        sp_colperm=pad(plan.sp_colperm, H_cp, 0),
        g_panel=pad(plan.g_panel, Tg, 0),
        g_cols=pad(plan.g_cols, Tg, max(plan.cols - 1, 0)),
        g_scatter=pad(plan.g_scatter, Tg, nnz),
        res_arow=pad(plan.res_arow, E, 0),
        res_col=pad(plan.res_col, E, 0),
        res_out=pad(plan.res_out, E, nnz),
        row_perm_padded=pad(plan.row_perm_padded, num_panels * ph, 0),
        num_panels=num_panels,
    )
    return out


def _unify_window_groups(plans: list, config: SddmmConfig) -> list:
    """Rebuild each shard plan's gathered/residual gather windows on one
    SHARED static group grid.

    Window groups are static metadata of the sddmm body, and the sharded
    path builds ONE body (from plans[0]) for every shard — so all
    shards must agree on (window_rows, a_window_rows, g_groups,
    res_groups). Per-shard packs agree on the B-side window size (it
    depends only on (N, k)) but not on which windows they touch or how
    many tiles/entries land in each; this pass takes the union of touched
    windows, pads every shard's per-window count up to the max with trash
    slots (scatter -> nnz, gather cols -> the window base, so pads stay
    window-pure and their output is dropped), and rewrites the arrays in
    the shared group order. num_gathered/num_residual become the padded
    group totals (the windowed body computes exactly the group slots and
    zero-fills the tail). Per-plan ``rphm_to_csr`` is NOT updated — the
    sharded csr map is rebuilt from the scatter arrays
    (parallel.sharding.sharded_rphm_to_csr). No-op when nothing windowed.
    This package's body runs windowed plans by absolute index, so the
    rewritten pads read valid rows and give the same values.
    """
    p0 = plans[0]
    W = p0.window_rows
    assert all(p.window_rows == W for p in plans), \
        "B-window size must be shard-independent"
    ph, bw, nnz, N, k = (p0.panel_height, p0.block_width, p0.nnz,
                         p0.cols, p0.k)
    new = list(plans)

    if W is not None:
        per_shard = []
        base_set = set()
        for p in plans:
            ng = p.num_gathered
            grp = p.g_cols[:ng, 0].astype(np.int64) // W
            base = np.minimum(grp * W, N - W)
            order = np.argsort(base, kind="stable")
            per_shard.append((base[order], order))
            base_set.update(np.unique(base).tolist())
        bases = np.asarray(sorted(base_set), np.int64)
        counts = np.zeros(bases.shape[0], np.int64)
        for sb, _ in per_shard:
            if sb.size:
                idx = np.searchsorted(bases, sb)
                counts = np.maximum(
                    counts, np.bincount(idx, minlength=bases.shape[0]))
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        num_g = int(offs[-1])
        # array length must stay an exact execution-chunk multiple (the
        # body's _chunk_of falls back to gcd(n, chunk) — an odd total
        # would collapse the chunk to 1 and explode the traced program)
        Tg_len = exec_size(num_g, config.bucket_shapes,
                           config.dense_chunk)
        g_groups = [(int(b), int(offs[i]), int(offs[i + 1]))
                    for i, b in enumerate(bases)]
        for si, p in enumerate(plans):
            sb, order = per_shard[si]
            g_panel = np.zeros(Tg_len, np.int32)
            g_cols = np.full((Tg_len, bw), max(N - 1, 0), np.int32)
            for i in range(bases.shape[0]):        # pad cols stay in-window
                g_cols[offs[i]:offs[i + 1]] = bases[i]
            g_scatter = np.full((Tg_len, ph, bw), nnz, np.int32)
            if sb.size:
                idx = np.searchsorted(bases, sb)
                within = np.arange(sb.size) - np.searchsorted(sb, sb)
                dest = offs[idx] + within
                ng = p.num_gathered
                g_panel[dest] = p.g_panel[:ng][order]
                g_cols[dest] = p.g_cols[:ng][order]
                g_scatter[dest] = p.g_scatter[:ng][order]
            new[si] = dataclasses.replace(
                new[si], g_panel=g_panel, g_cols=g_cols,
                g_scatter=g_scatter, num_gathered=num_g,
                g_groups=g_groups if num_g else None)

    # ---- residual: (A-window, B-window) pair groups on the common grid --
    a_rows_c = max(p.row_perm_padded.shape[0] for p in plans)
    Wa = None
    if (config.gather_window_mb
            and a_rows_c * k * 4 > (config.gather_window_threshold_mb
                                    << 20)):
        awr = max((config.gather_window_mb << 20) // (k * 4), ph)
        awr = max(awr, -(-a_rows_c // max(config.max_gather_groups, 1)))
        if a_rows_c > 2 * awr:
            Wa = awr
    if W is None and Wa is None:
        return new

    def pair_keys(p, use_a):
        ne = p.num_residual
        rows = p.res_arow[:ne].astype(np.int64)
        cols = p.res_col[:ne].astype(np.int64)
        ab = (np.minimum(rows // Wa * Wa, a_rows_c - Wa)
              if (Wa and use_a) else np.full(ne, -1, np.int64))
        bb = (np.minimum(cols // W * W, N - W) if W
              else np.full(ne, -1, np.int64))
        return ab, bb

    use_a = Wa is not None
    pair_set = set()
    for p in plans:
        ab, bb = pair_keys(p, use_a)
        pair_set.update({(int(a), int(b)) for a, b in
                         zip(*(np.unique(np.stack([ab, bb]), axis=1)))})
    if use_a and len(pair_set) > 2 * max(config.max_gather_groups, 1):
        # same budget rule as pack_tiles: drop the A side first
        use_a = False
        pair_set = set()
        for p in plans:
            ab, bb = pair_keys(p, use_a)
            pair_set.update({(int(a), int(b)) for a, b in
                             zip(*(np.unique(np.stack([ab, bb]),
                                             axis=1)))})
    pairs = sorted(pair_set)
    pkeys = np.asarray([a * (N + 2) + b for a, b in pairs], np.int64) \
        if pairs else np.zeros(0, np.int64)
    counts = np.zeros(len(pairs), np.int64)
    shard_keys = []
    for p in plans:
        ab, bb = pair_keys(p, use_a)
        key = ab * (N + 2) + bb
        order = np.argsort(key, kind="stable")
        shard_keys.append((key[order], order))
        if key.size:
            idx = np.searchsorted(pkeys, key)
            counts = np.maximum(
                counts, np.bincount(idx, minlength=len(pairs)))
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    num_r = int(offs[-1])
    # exact execution-chunk multiple (see the gathered-tier note above)
    E_len = exec_size(num_r, config.bucket_shapes, config.residual_chunk)
    res_groups = [(int(a), int(b), int(offs[i]), int(offs[i + 1]))
                  for i, (a, b) in enumerate(pairs)]
    for si, p in enumerate(plans):
        ks, order = shard_keys[si]
        res_arow = np.zeros(E_len, np.int32)
        res_col = np.zeros(E_len, np.int32)
        for i, (a, b) in enumerate(pairs):        # pads stay in-window
            res_arow[offs[i]:offs[i + 1]] = max(a, 0)
            res_col[offs[i]:offs[i + 1]] = max(b, 0)
        res_out = np.full(E_len, nnz, np.int32)
        if ks.size:
            idx = np.searchsorted(pkeys, ks)
            within = np.arange(ks.size) - np.searchsorted(ks, ks)
            dest = offs[idx] + within
            ne = p.num_residual
            res_arow[dest] = p.res_arow[:ne][order]
            res_col[dest] = p.res_col[:ne][order]
            res_out[dest] = p.res_out[:ne][order]
        new[si] = dataclasses.replace(
            new[si], res_arow=res_arow, res_col=res_col, res_out=res_out,
            num_residual=num_r,
            res_groups=res_groups if num_r else None,
            a_window_rows=Wa if use_a else None)
    return new


def panel_cost_weights(csr: CSR, reord: BsmrReordering,
                       config: SddmmConfig,
                       k: Optional[int] = None) -> np.ndarray:
    """Per-panel predicted kernel cost (ns) for shard balancing.

    A sharded call runs at the SLOWEST shard, and a panel's time is
    dominated by its dense TILE count (each tile's output DMA is
    nnz-independent) plus its residual nonzeros at the per-nnz
    descriptor rate — NOT by its nnz. nnz-only balancing leaves
    1.4-1.5x tile-count skew on power-law masks
    (results/v5e_r3/scaling_model.json), so the shard splitter balances
    on the cost model's own weights. Gathered-tier slots price within
    ~1.5x of per-nnz entries, close enough for a balance weight. The
    prices are the JAX package's TPU v5e table (``V5E_COSTS``), kept so
    that the shard bounds, and so the shard plans, equal the JAX
    package's; they say nothing about the card.
    """
    from bsmr_sddmm_tpu_torch.autotune import V5E_COSTS as _C  # lazy: no cycle
    k = config.k if k is None else k
    ph, bw = config.panel_height, config.block_width
    perm = reord.row_perm.astype(np.int64)
    num_panels = reord.num_row_panels
    dco = reord.dense_col_offsets
    tiles_p = (np.diff(dco) // bw).astype(np.float64)
    # dense nnz per panel: the same membership join as pack_tiles, kept
    # to per-panel counts (no maps)
    row_nnz = csr.row_nnz()
    perm_nnz = row_nnz[perm]
    pos = np.repeat(np.arange(perm.shape[0], dtype=np.int64), perm_nnz)
    panel_of_entry = pos // ph
    eidx = _concat_ranges(csr.row_offsets[perm], perm_nnz)
    cols = csr.col_indices[eidx].astype(np.int64)
    sent = np.int64(csr.cols + 1)
    dense_keys = (np.repeat(np.arange(num_panels, dtype=np.int64),
                            np.diff(dco)) * sent + reord.dense_cols)
    ds = np.argsort(dense_keys, kind="stable")
    dks = dense_keys[ds]
    ek = panel_of_entry * sent + cols
    if dks.shape[0]:
        p2 = np.minimum(np.searchsorted(dks, ek), dks.shape[0] - 1)
        is_dense = dks[p2] == ek
    else:
        is_dense = np.zeros(ek.shape[0], dtype=bool)
    dense_nnz_p = np.bincount(panel_of_entry[is_dense],
                              minlength=num_panels).astype(np.float64)
    panel_nnz = np.bincount(panel_of_entry,
                            minlength=num_panels).astype(np.float64)
    G = max(config.dense_fat_group, 1)
    dense_ns = (_C["dense_floor_base_ns"] + _C["dense_floor_k_ns"] * k
                + (_C["dense_step_base_ns"]
                   + _C["dense_step_k_ns"] * k) / G)
    per_ns = _C["pernnz_base_ns"] + _C["pernnz_k_ns"] * k
    return tiles_p * dense_ns + (panel_nnz - dense_nnz_p) * per_ns


def pack_shard_plans(csr: CSR, reord: BsmrReordering, config: SddmmConfig,
                     n_shards: int, k: Optional[int] = None,
                     balance: str = "cost") -> list:
    """Row-panel sharding: split the reordered panels into ``n_shards``
    contiguous, cost-balanced ranges (``balance="cost"``, the default:
    per-panel predicted kernel cost from :func:`panel_cost_weights`;
    ``balance="nnz"`` keeps the round-2 nnz split) and pack each range
    independently — each shard keeps fat steps (one common fat group, a
    static of the shared sharded body) and its own
    bucketed-then-padded-common shapes. Scatter indices stay GLOBAL
    (into csr.nnz), so the shard outputs are exact disjoint pieces of
    the full rphm layout.

    This replaces round 1's slice-a-global-plan approach, which silently
    dropped fat steps and gather windows. Gather windows are kept: window
    groups must be identical static metadata across shards under one
    sharded body, so per-shard groups are rewritten onto a shared
    static window grid (:func:`_unify_window_groups`).
    """
    if reord.dense_cols is None:
        raise ValueError("run the column split (split_columns) first")
    # windows stay ON: per-shard packs produce per-shard window groups,
    # and _unify_window_groups below rewrites them onto one shared static
    # grid (a single sharded body serves every shard) — cliff-scale B
    # keeps the windowed-gather protection under multi-chip
    cfg = config
    ph = cfg.panel_height
    perm = reord.row_perm
    R = perm.shape[0]
    num_panels = reord.num_row_panels
    # per-panel weight -> contiguous balanced ranges
    if balance == "cost":
        weights = panel_cost_weights(csr, reord, cfg, k=k)
    elif balance == "nnz":
        row_nnz = csr.row_nnz()[perm]
        pad_rows = num_panels * ph - R
        weights = np.concatenate(
            [row_nnz, np.zeros(pad_rows, np.int64)]) \
            .reshape(num_panels, ph).sum(axis=1).astype(np.float64)
    else:
        raise ValueError(f"unknown balance {balance!r}")
    cum = np.concatenate([[0.0], np.cumsum(weights)])
    targets = cum[-1] * np.arange(1, n_shards) / n_shards
    bounds = np.concatenate([[0], np.searchsorted(cum, targets),
                             [num_panels]]).astype(np.int64)
    bounds = np.maximum.accumulate(bounds)

    dco = reord.dense_col_offsets
    shard_plans = []
    for s in range(n_shards):
        p0, p1 = int(bounds[s]), int(bounds[s + 1])
        rows = perm[p0 * ph: min(p1 * ph, R)]
        if rows.size == 0:
            rows = perm[:0]
        sub = dataclasses.replace(
            reord,
            row_perm=rows,
            cluster_ids=reord.cluster_ids[p0 * ph: min(p1 * ph, R)],
            dense_cols=reord.dense_cols[dco[p0]:dco[p1]],
            dense_col_offsets=(dco[p0:p1 + 1] - dco[p0]),
        )
        shard_plans.append(pack_tiles(csr, sub, cfg, k=k,
                                      fat_group_override=1))
    # common fat group: largest power of two every shard can be regrouped
    # to is 1 unless we re-pack; instead re-pack with the global adaptive G
    tile_counts = [p.num_tiles for p in shard_plans]
    if cfg.dense_fat_group > 1 and any(tile_counts):
        meds = []
        for p in shard_plans:
            if p.num_tiles and p.tile_cblock is not None:
                cb = p.tile_cblock[:p.num_tiles]
                starts = np.nonzero(np.diff(cb, prepend=-1))[0]
                meds.append(int(np.median(np.diff(
                    np.append(starts, p.num_tiles)))))
        med = min(meds) if meds else 1
        G = 1
        while G * 2 <= cfg.dense_fat_group and G * 2 <= med:
            G *= 2
        if G > 1:
            shard_plans = []
            for s in range(n_shards):
                p0, p1 = int(bounds[s]), int(bounds[s + 1])
                rows = perm[p0 * ph: min(p1 * ph, R)]
                sub = dataclasses.replace(
                    reord,
                    row_perm=rows,
                    cluster_ids=reord.cluster_ids[p0 * ph: min(p1 * ph, R)],
                    dense_cols=reord.dense_cols[dco[p0]:dco[p1]],
                    dense_col_offsets=(dco[p0:p1 + 1] - dco[p0]),
                )
                shard_plans.append(pack_tiles(csr, sub, cfg, k=k,
                                              fat_group_override=G))
    if any(p.window_rows or p.a_window_rows for p in shard_plans):
        shard_plans = _unify_window_groups(shard_plans, cfg)
    # pad to common shapes
    T = max(p.tile_panel.shape[0] for p in shard_plans)
    Tp = max(p.sp_panel.shape[0] for p in shard_plans)
    Tg = max(p.g_panel.shape[0] for p in shard_plans)
    E = max(p.res_arow.shape[0] for p in shard_plans)
    NP = max(max(p.num_panels for p in shard_plans), 1)
    H_cp = max(p.sp_colperm.shape[0] for p in shard_plans)
    return [_pad_plan_to(p, T, Tp, Tg, E, NP, H_cp) for p in shard_plans]
