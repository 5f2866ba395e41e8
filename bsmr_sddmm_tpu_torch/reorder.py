"""BSMR reordering: row-similarity clustering + per-panel column split.

A copy of ``bsmr_sddmm_tpu.reorder`` (plain NumPy/SciPy), kept in this
package because importing ``bsmr_sddmm_tpu`` imports JAX; the same mask
gives the same arrays in both packages (tests/test_torch_host.py). It
re-implements, host-side and vectorized, the CUDA original's two-stage
preprocessing:

* Row reordering (src/rowReordering.cu): every row is encoded as a
  histogram over ``encoding_block``-wide column blocks
  (kernel::calculateDispersion, rowReordering.cu:49-93); rows are sorted
  ascending by a dispersion score; a greedy pass clusters rows whose
  *normalized weighted Jaccard* similarity with the (accumulating) cluster
  representative exceeds ``alpha`` (bsa_clustering, rowReordering.cu:325-432);
  the final permutation orders rows by cluster, dropping empty rows
  (get_permutation_gpu, rowReordering.cu:893-1007).

* Column split: rows are cut into panels of ``panel_height``. With
  ``col_mode="bsr"`` (:func:`col_split_bsr`) the natural
  ``block_width``-wide column blocks of a panel whose nonzero count reaches
  ``ceil(delta * panel_height * block_width)`` become *dense* tiles. With
  ``col_mode="reorder"`` (:func:`col_reordering`, the original's
  src/colReordering.cu:274-404) a panel's nonzero columns are sorted
  descending by in-panel count, padded to a multiple of ``block_width``
  with a sentinel, and the leading groups that reach the same threshold
  become dense column groups. The rest is the *sparse residual*.

Clustering is a host-side algorithm with two strategies: ``exact``
(faithful accumulate-greedy semantics, vectorized sweeps) and ``fast``
(static-representative greedy: identical except the representative encoding
does not accumulate members — one exact vectorized Jaccard sweep per
cluster).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR


# ---------------------------------------------------------------------------
# Row encodings + dispersion
# ---------------------------------------------------------------------------

def row_encodings(csr: CSR, encoding_block: int) -> sp.csr_matrix:
    """Per-row histogram over column blocks (reference
    kernel::calculateDispersion SMEM build, rowReordering.cu:72-76).

    Returns a scipy CSR of shape (rows, ceil(cols/encoding_block)) whose
    (r, b) entry counts the nonzeros of row r falling in column block b.
    """
    nblocks = -(-csr.cols // encoding_block)
    rows = csr.coo_rows()
    blocks = csr.col_indices // encoding_block
    enc = sp.csr_matrix(
        (np.ones(csr.nnz, np.float32), (rows, blocks)),
        shape=(csr.rows, nblocks),
    )
    enc.sum_duplicates()
    return enc


def dispersion_scores(csr: CSR, enc: sp.csr_matrix,
                      encoding_block: int) -> np.ndarray:
    """Dispersion score per row (rowReordering.cu:81-92):

        score(r) = sum over nonzero blocks of (encoding_block - count)
                 + nnz(r) * num_nonzero_blocks(r)
                 = encoding_block*nb - nnz + nnz*nb.
    """
    row_nnz = csr.row_nnz().astype(np.int64)
    nb = np.diff(enc.indptr).astype(np.int64)  # nonzero blocks per row
    return encoding_block * nb - row_nnz + row_nnz * nb


# ---------------------------------------------------------------------------
# Normalized weighted Jaccard sweeps
# ---------------------------------------------------------------------------

def _normalized_rows(enc: sp.csr_matrix) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row L2 norms and L1-of-normalized norms of the encodings."""
    sq = enc.copy()
    sq.data = sq.data * sq.data
    l2 = np.sqrt(np.asarray(sq.sum(axis=1)).ravel())
    l1 = np.asarray(enc.sum(axis=1)).ravel()
    l1_hat = np.divide(l1, l2, out=np.zeros_like(l1, dtype=np.float64),
                       where=l2 > 0)
    return l2, l1_hat


def _jaccard_sweep(acc: np.ndarray, enc_rows: sp.csr_matrix,
                   l2: np.ndarray, l1_hat: np.ndarray) -> np.ndarray:
    """Exact normalized weighted Jaccard of a dense accumulator encoding
    against many sparse row encodings (reference
    calculate_similarity_norm_weighted_jaccard, rowReordering.cu:235-293):

        sim(a, b) = sum_k min(a_hat_k, b_hat_k) / sum_k max(a_hat_k, b_hat_k)

    with x_hat = x / ||x||_2. Uses sum(max) = ||a_hat||_1 + ||b_hat||_1
    - sum(min), and that min against an implicit zero is zero for
    nonnegative encodings, so only b's support needs touching.
    """
    acc_l2 = np.sqrt(float(np.dot(acc, acc)))
    if acc_l2 == 0.0:
        return np.zeros(enc_rows.shape[0])
    acc_hat = acc / acc_l2
    acc_l1 = float(acc_hat.sum())
    nnz_per_row = np.diff(enc_rows.indptr)
    data_hat = enc_rows.data / np.repeat(l2, nnz_per_row)
    m = np.minimum(acc_hat[enc_rows.indices], data_hat)
    # segment sum per row; rows here always have >= 1 nonzero
    smin = np.add.reduceat(m, enc_rows.indptr[:-1]) if m.size else \
        np.zeros(enc_rows.shape[0])
    smin = np.where(nnz_per_row > 0, smin, 0.0)
    smax = acc_l1 + l1_hat - smin
    return smin / smax


# ---------------------------------------------------------------------------
# Row reordering strategies
# ---------------------------------------------------------------------------

def _cluster_exact(enc: sp.csr_matrix, order: np.ndarray,
                   alpha: float) -> np.ndarray:
    """Faithful greedy clustering with representative accumulation
    (bsa_clustering, rowReordering.cu:361-431): scan rows in ascending
    dispersion order; the first unassigned row seeds a cluster; every later
    unassigned row whose similarity with the *accumulated* representative
    encoding exceeds alpha joins, and its encoding is added into the
    representative (rowReordering.cu:393-397).

    Vectorized as: one Jaccard sweep over the remaining suffix per join —
    rows before the first hit are exactly the rows the reference rejects
    against the same accumulator state.

    Returns cluster ids aligned with ``order`` positions (0-based).
    """
    n = order.shape[0]
    cluster_of_pos = np.full(n, -1, dtype=np.int64)
    enc_ord = enc[order]  # CSR rows in ascending-dispersion order
    l2, l1_hat = _normalized_rows(enc_ord)
    active = np.arange(n)  # positions still unassigned, ascending
    cid = 0
    nblocks = enc.shape[1]
    while active.size:
        rep_pos = active[0]
        cluster_of_pos[rep_pos] = cid
        acc = np.zeros(nblocks, dtype=np.float64)
        rep_row = enc_ord[rep_pos]
        acc[rep_row.indices] = rep_row.data
        members = [0]  # indices into `active`
        scan = 1
        while scan < active.size:
            tail = active[scan:]
            sims = _jaccard_sweep(acc, enc_ord[tail], l2[tail], l1_hat[tail])
            hits = np.nonzero(sims > alpha)[0]
            if hits.size == 0:
                break
            j = scan + int(hits[0])
            jpos = active[j]
            cluster_of_pos[jpos] = cid
            jrow = enc_ord[jpos]
            acc[jrow.indices] += jrow.data
            members.append(j)
            scan = j + 1
        mask = np.ones(active.size, dtype=bool)
        mask[np.asarray(members)] = False
        active = active[mask]
        cid += 1
    return cluster_of_pos


def _cluster_fast(enc: sp.csr_matrix, order: np.ndarray,
                  alpha: float) -> np.ndarray:
    """Static-representative greedy clustering: identical to ``exact``
    except the representative encoding is the seed row's alone (no
    accumulation), which needs exactly one vectorized Jaccard sweep per
    cluster. Same alpha semantics; clusters are marginally tighter."""
    n = order.shape[0]
    cluster_of_pos = np.full(n, -1, dtype=np.int64)
    enc_ord = enc[order]
    l2, l1_hat = _normalized_rows(enc_ord)
    active = np.arange(n)
    cid = 0
    nblocks = enc.shape[1]
    while active.size:
        rep_pos = active[0]
        acc = np.zeros(nblocks, dtype=np.float64)
        rep_row = enc_ord[rep_pos]
        acc[rep_row.indices] = rep_row.data
        tail = active[1:]
        if tail.size:
            sims = _jaccard_sweep(acc, enc_ord[tail], l2[tail], l1_hat[tail])
            hit = np.nonzero(sims > alpha)[0]
        else:
            hit = np.zeros(0, np.int64)
        member_pos = np.concatenate([[rep_pos], tail[hit]])
        cluster_of_pos[member_pos] = cid
        keep = np.ones(tail.size, dtype=bool)
        keep[hit] = False
        active = tail[keep]
        cid += 1
    return cluster_of_pos


def _cluster_native(enc: sp.csr_matrix, order: np.ndarray, alpha: float,
                    exact: bool) -> Optional[np.ndarray]:
    """C++/OpenMP clustering (bsmr_sddmm_tpu_torch.native); same
    semantics as the NumPy strategies. Returns None when the native
    library cannot be built (reorder falls back to NumPy)."""
    from bsmr_sddmm_tpu_torch import native
    if not native.available():
        return None
    enc_ord = enc[order].tocsr()
    l2, l1_hat = _normalized_rows(enc_ord)
    nnz_per_row = np.diff(enc_ord.indptr)
    data_hat = enc_ord.data / np.repeat(np.maximum(l2, 1e-300),
                                        nnz_per_row)
    return native.cluster(enc_ord.indptr.astype(np.int64),
                          enc_ord.indices.astype(np.int32),
                          enc_ord.data.astype(np.float64), data_hat,
                          l1_hat.astype(np.float64),
                          enc.shape[1], alpha, exact=exact)


@dataclasses.dataclass
class BsmrReordering:
    """Result of the BSMR preprocessing (reference class BSMR,
    include/BSMR.hpp:21-63)."""

    row_perm: np.ndarray          # (R,) original row ids, empty rows dropped
    cluster_ids: np.ndarray       # (R,) cluster id per reordered row
    num_clusters: int
    row_time_ms: float
    # column split (filled by col_reordering)
    dense_cols: Optional[np.ndarray] = None        # concat per panel
    dense_col_offsets: Optional[np.ndarray] = None  # (panels+1,)
    sparse_cols: Optional[np.ndarray] = None
    sparse_col_offsets: Optional[np.ndarray] = None
    sparse_value_offsets: Optional[np.ndarray] = None  # nnz per panel scan
    col_time_ms: float = 0.0
    panel_height: int = 0
    block_width: int = 0
    delta: float = float("nan")

    @property
    def num_row_panels(self) -> int:
        return -(-self.row_perm.shape[0] // self.panel_height) \
            if self.panel_height else 0


def row_reordering(csr: CSR, alpha: float, config: SddmmConfig
                   ) -> BsmrReordering:
    """Full row-reordering driver (reference bsa_rowReordering_gpu,
    rowReordering.cu:1027-1095): encode rows, score dispersion, sort
    ascending, cluster greedily, emit a permutation ordered by cluster id
    with empty rows dropped (rowReordering.cu:986-996, 1081-1090)."""
    t0 = time.perf_counter()
    if config.row_strategy == "none":
        nonzero = np.nonzero(csr.row_nnz() > 0)[0]
        elapsed = (time.perf_counter() - t0) * 1e3
        return BsmrReordering(
            row_perm=nonzero.astype(np.int64),
            cluster_ids=np.zeros(nonzero.shape[0], np.int64),
            num_clusters=1 if nonzero.size else 0,
            row_time_ms=elapsed,
        )
    enc = row_encodings(csr, config.encoding_block)
    disp = dispersion_scores(csr, enc, config.encoding_block)
    row_nnz = csr.row_nnz()
    nonzero_rows = np.nonzero(row_nnz > 0)[0]
    # ascending dispersion, stable on ties (the reference's thrust sort is
    # unstable; stable makes results deterministic)
    order_local = np.argsort(disp[nonzero_rows], kind="stable")
    order = nonzero_rows[order_local]  # original row ids, ascending disp
    cluster_of_pos = None
    if config.use_native:
        cluster_of_pos = _cluster_native(enc, order, alpha,
                                         exact=config.row_strategy
                                         == "exact")
    if cluster_of_pos is None:
        if config.row_strategy == "exact":
            if config.use_native and order.size > 50_000:
                # the NumPy exact path is O(joins x suffix); on a big
                # matrix the silent native->NumPy fallback can turn
                # seconds into minutes — say so at the decision site
                import warnings
                warnings.warn(
                    f"native clustering unavailable; NumPy 'exact' "
                    f"clustering of {order.size} rows may take minutes",
                    RuntimeWarning, stacklevel=2)
            cluster_of_pos = _cluster_exact(enc, order, alpha)
        else:
            cluster_of_pos = _cluster_fast(enc, order, alpha)
    # final permutation: stable sort of the ascending-dispersion row order
    # by cluster id (rowReordering.cu:986-996)
    final = np.argsort(cluster_of_pos, kind="stable")
    row_perm = order[final]
    cluster_ids = cluster_of_pos[final]
    elapsed = (time.perf_counter() - t0) * 1e3
    return BsmrReordering(
        row_perm=row_perm.astype(np.int64),
        cluster_ids=cluster_ids,
        num_clusters=int(cluster_ids[-1]) + 1 if cluster_ids.size else 0,
        row_time_ms=elapsed,
    )


# ---------------------------------------------------------------------------
# Column reordering
# ---------------------------------------------------------------------------

def _concat_ranges(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenate [starts[i], starts[i]+lengths[i]) ranges, vectorized."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    nonempty = lengths > 0
    s = starts[nonempty].astype(np.int64)
    ln = lengths[nonempty].astype(np.int64)
    out = np.ones(total, np.int64)
    out[0] = s[0]
    ends = np.cumsum(ln)
    if s.shape[0] > 1:
        out[ends[:-1]] = s[1:] - (s[:-1] + ln[:-1] - 1)
    return np.cumsum(out)


def col_reordering(csr: CSR, reord: BsmrReordering,
                   config: SddmmConfig,
                   delta: Optional[float] = None) -> BsmrReordering:
    """Per-panel column reorder + dense/sparse split (reference
    colReordering_cpu, colReordering.cu:274-404), fully vectorized across
    panels (the reference parallelizes with OpenMP; we sort once globally).

    Fills the dense/sparse column fields of ``reord`` in place and returns
    it. ``dense_cols`` may contain the sentinel ``csr.cols`` for padding
    (colReordering.cu:338-343); sentinel columns never reach the residual.
    """
    t0 = time.perf_counter()
    delta = config.delta if delta is None else delta
    ph, bw = config.panel_height, config.block_width
    perm = reord.row_perm
    R = perm.shape[0]
    num_panels = -(-R // ph) if R else 0
    N = csr.cols
    threshold = int(np.ceil(delta * ph * bw))

    # (panel, col) nonzero counts over the reordered rows
    row_nnz = csr.row_nnz()
    perm_nnz = row_nnz[perm]
    panel_of_entry = np.repeat(np.arange(R, dtype=np.int64) // ph, perm_nnz)
    entry_idx = _concat_ranges(csr.row_offsets[perm], perm_nnz)
    cols_of_entry = csr.col_indices[entry_idx].astype(np.int64)
    keys = panel_of_entry * np.int64(N) + cols_of_entry
    uniq, counts = np.unique(keys, return_counts=True)
    pc_panel = uniq // N
    pc_col = uniq % N
    # within each panel: count descending, column ascending on ties
    # (reference thrust descending sort is unstable on ties; this is the
    # deterministic choice)
    sort_idx = np.lexsort((pc_col, -counts, pc_panel))
    pc_panel = pc_panel[sort_idx]
    pc_col = pc_col[sort_idx]
    counts = counts[sort_idx]

    # per-panel segment boundaries in the sorted arrays
    panel_starts = np.searchsorted(pc_panel, np.arange(num_panels + 1))
    panel_len = np.diff(panel_starts)          # nonzero cols per panel
    padded_len = -(-panel_len // bw) * bw      # pad to multiple of bw

    # scatter sorted (col, count) into a padded layout:
    # slot p*maxpad.. but memory-friendlier: offsets per panel
    padded_offsets = np.zeros(num_panels + 1, np.int64)
    np.cumsum(padded_len, out=padded_offsets[1:])
    total_padded = int(padded_offsets[-1])
    cols_padded = np.full(total_padded, N, dtype=np.int64)    # sentinel pad
    counts_padded = np.zeros(total_padded, dtype=np.int64)
    within = np.arange(pc_panel.shape[0], dtype=np.int64) \
        - panel_starts[pc_panel]
    dest = padded_offsets[pc_panel] + within
    cols_padded[dest] = pc_col
    counts_padded[dest] = counts

    # group (tile-column) sums, bw entries per group
    num_groups = total_padded // bw
    group_sums = counts_padded.reshape(num_groups, bw).sum(axis=1)
    group_panel = np.repeat(np.arange(num_panels), padded_len // bw)
    dense_group = group_sums >= threshold
    # counts are descending within a panel, so passing groups are a prefix;
    # enforce it anyway (guards the delta=0 all-dense and padded-tail cases)
    # via a per-panel cumulative AND.
    if num_groups:
        grp_starts = np.zeros(num_panels + 1, np.int64)
        np.cumsum(padded_len // bw, out=grp_starts[1:])
        # cumulative AND within panel: a group is dense iff all groups
        # before it in the panel are dense too
        not_dense = ~dense_group
        first_fail = np.full(num_panels, np.iinfo(np.int64).max)
        fail_idx = np.nonzero(not_dense)[0]
        if fail_idx.size:
            np.minimum.at(first_fail, group_panel[fail_idx], fail_idx)
        dense_group = (np.arange(num_groups)
                       < first_fail[group_panel])

    dense_cols_count = np.zeros(num_panels, np.int64)
    if num_groups:
        np.add.at(dense_cols_count, group_panel, dense_group * bw)

    # dense cols: the first dense_cols_count[p] padded cols of each panel
    dense_col_offsets = np.zeros(num_panels + 1, np.int64)
    np.cumsum(dense_cols_count, out=dense_col_offsets[1:])
    dense_sel = _concat_ranges(padded_offsets[:-1], dense_cols_count)
    dense_cols = cols_padded[dense_sel]

    # sparse cols: the remaining *real* (non-sentinel) cols of each panel
    sparse_start = padded_offsets[:-1] + dense_cols_count
    sparse_real_len = np.maximum(panel_len - dense_cols_count, 0)
    sparse_sel = _concat_ranges(sparse_start, sparse_real_len)
    sparse_cols = cols_padded[sparse_sel]
    sparse_counts = counts_padded[sparse_sel]
    sparse_col_offsets = np.zeros(num_panels + 1, np.int64)
    np.cumsum(sparse_real_len, out=sparse_col_offsets[1:])

    # residual nnz per panel (reference sparseValueOffsets,
    # colReordering.cu:352-369)
    sparse_nnz_per_panel = np.zeros(num_panels, np.int64)
    if sparse_counts.size:
        panel_of_sparse = np.repeat(np.arange(num_panels), sparse_real_len)
        np.add.at(sparse_nnz_per_panel, panel_of_sparse, sparse_counts)
    sparse_value_offsets = np.zeros(num_panels + 1, np.int64)
    np.cumsum(sparse_nnz_per_panel, out=sparse_value_offsets[1:])

    reord.dense_cols = dense_cols
    reord.dense_col_offsets = dense_col_offsets
    reord.sparse_cols = sparse_cols
    reord.sparse_col_offsets = sparse_col_offsets
    reord.sparse_value_offsets = sparse_value_offsets
    reord.col_time_ms = (time.perf_counter() - t0) * 1e3
    reord.panel_height = ph
    reord.block_width = bw
    reord.delta = delta
    return reord


def col_split_bsr(csr: CSR, reord: BsmrReordering,
                  config: SddmmConfig,
                  delta: Optional[float] = None) -> BsmrReordering:
    """Column split without column permutation (``col_mode="bsr"``). A
    panel's dense tiles are the *natural* ``block_width``-wide column
    blocks whose in-panel nnz meets ``ceil(delta * panel_height *
    block_width)``; everything else is residual. Emits the field structure
    of the column reordering (dense_cols are the blocks' own columns,
    ascending, sentinel-padded at the matrix edge), so packing and checking
    are shared. Each dense tile's B operand is then a contiguous slice of
    B^T: no per-tile column gather.
    """
    t0 = time.perf_counter()
    delta = config.delta if delta is None else delta
    ph, bw = config.panel_height, config.block_width
    perm = reord.row_perm
    R = perm.shape[0]
    num_panels = -(-R // ph) if R else 0
    N = csr.cols
    nb = -(-N // bw)  # column blocks per row
    threshold = max(int(np.ceil(delta * ph * bw)), 1)

    # (panel, col) counts over reordered rows — same enumeration as
    # col_reordering
    row_nnz = csr.row_nnz()
    perm_nnz = row_nnz[perm]
    panel_of_entry = np.repeat(np.arange(R, dtype=np.int64) // ph, perm_nnz)
    entry_idx = _concat_ranges(csr.row_offsets[perm], perm_nnz)
    cols_of_entry = csr.col_indices[entry_idx].astype(np.int64)
    keys = panel_of_entry * np.int64(N) + cols_of_entry
    uniq, counts = np.unique(keys, return_counts=True)
    pc_panel = uniq // N
    pc_col = uniq % N

    # per (panel, cblock) counts
    pc_cblock = pc_col // bw
    bkeys = pc_panel * np.int64(nb) + pc_cblock
    buniq_pos = np.nonzero(np.diff(bkeys, prepend=-1))[0]
    buniq = bkeys[buniq_pos]
    bcounts = np.add.reduceat(counts, buniq_pos)
    dense_block = bcounts >= threshold

    db_keys = buniq[dense_block]               # dense (panel, cblock) keys
    db_panel = db_keys // nb
    db_cblock = db_keys % nb
    blocks_per_panel = np.zeros(num_panels, np.int64)
    np.add.at(blocks_per_panel, db_panel, 1)

    dense_col_offsets = np.zeros(num_panels + 1, np.int64)
    np.cumsum(blocks_per_panel * bw, out=dense_col_offsets[1:])
    # dense cols: each block contributes its own bw columns ascending,
    # sentinel N past the matrix edge
    base = (db_cblock * bw)[:, None] + np.arange(bw)[None, :]
    dense_cols = np.where(base < N, base, N).reshape(-1)

    # sparse (residual) side: nonzero cols not inside a dense block
    entry_in_dense = np.isin(bkeys, db_keys)
    sp_mask = ~entry_in_dense
    sp_panel = pc_panel[sp_mask]
    sparse_cols = pc_col[sp_mask]
    sparse_counts = counts[sp_mask]
    sparse_per_panel = np.zeros(num_panels, np.int64)
    np.add.at(sparse_per_panel, sp_panel, 1)
    sparse_col_offsets = np.zeros(num_panels + 1, np.int64)
    np.cumsum(sparse_per_panel, out=sparse_col_offsets[1:])
    sparse_nnz_per_panel = np.zeros(num_panels, np.int64)
    np.add.at(sparse_nnz_per_panel, sp_panel, sparse_counts)
    sparse_value_offsets = np.zeros(num_panels + 1, np.int64)
    np.cumsum(sparse_nnz_per_panel, out=sparse_value_offsets[1:])

    reord.dense_cols = dense_cols
    reord.dense_col_offsets = dense_col_offsets
    reord.sparse_cols = sparse_cols
    reord.sparse_col_offsets = sparse_col_offsets
    reord.sparse_value_offsets = sparse_value_offsets
    reord.col_time_ms = (time.perf_counter() - t0) * 1e3
    reord.panel_height = ph
    reord.block_width = bw
    reord.delta = delta
    return reord


def split_columns(csr: CSR, reord: BsmrReordering, config: SddmmConfig,
                  delta: Optional[float] = None) -> BsmrReordering:
    """Dispatch on ``config.col_mode``."""
    if config.col_mode == "bsr":
        return col_split_bsr(csr, reord, config, delta)
    return col_reordering(csr, reord, config, delta)


def bsmr(csr: CSR, config: SddmmConfig) -> BsmrReordering:
    """Row + column reordering in one call (reference BSMR::BSMR,
    src/BSMR.cpp:16-25)."""
    reord = row_reordering(csr, config.alpha, config)
    return split_columns(csr, reord, config)
