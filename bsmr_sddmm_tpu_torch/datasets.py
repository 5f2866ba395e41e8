"""Synthetic matrix generators shaped like the reference's dataset.

The reference benchmarks on 503 SuiteSparse matrices filtered to
m,n >= 10000 and nnz >= 100000 with all values rewritten to 1
(scripts/exclude_invalid_dataset.py:44-76). SuiteSparse at that scale is
real structure: FEM/mesh matrices (banded, local), circuit and web/social
graphs (power-law degrees, communities), optimization matrices (blocked).
Pure-uniform random masks are *not* representative — they are the
adversarial worst case for any locality-exploiting method (the reference's
own suite contains few). This module generates the structured families so
the benchmark suite exercises the same regimes the reference measured,
plus uniform noise kept as the honest worst case.

All generators are deterministic in ``seed`` and return CSR with values 1,
identical to ``bsmr_sddmm_tpu.datasets`` for the same seed (this module is
its copy, kept here because importing ``bsmr_sddmm_tpu`` imports JAX).
"""

from __future__ import annotations

import numpy as np

from bsmr_sddmm_tpu_torch.formats import COO, CSR


def _dedup_to_csr(rows, cols, n_rows, n_cols) -> CSR:
    keys = rows.astype(np.int64) * np.int64(n_cols) + cols.astype(np.int64)
    uniq = np.unique(keys)
    ri = (uniq // n_cols).astype(np.int32)
    ci = (uniq % n_cols).astype(np.int32)
    return COO(n_rows, n_cols, ri, ci,
               np.ones(uniq.shape[0], np.float32)).to_csr()


def rmat(n: int, nnz: int, seed: int = 0, a: float = 0.57,
         b: float = 0.19, c: float = 0.19) -> CSR:
    """R-MAT / Kronecker graph (Chakrabarti et al.) — the standard model
    for power-law web/social/circuit structure. Quadrant probabilities
    (a, b, c, d=1-a-b-c) recurse over log2(n) bits; the defaults are the
    Graph500 parameters."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    m = int(nnz * 1.15)  # oversample: dedup + clip losses
    rows = np.zeros(m, np.int64)
    cols = np.zeros(m, np.int64)
    d = 1.0 - a - b - c
    for bit in range(scale):
        r = rng.random(m)
        row_bit = (r >= a + b).astype(np.int64)
        col_bit = (((r >= a) & (r < a + b))
                   | (r >= a + b + c)).astype(np.int64)
        rows = (rows << 1) | row_bit
        cols = (cols << 1) | col_bit
    keep = (rows < n) & (cols < n)
    return _dedup_to_csr(rows[keep], cols[keep], n, n)


def banded(n: int, nnz: int, bandwidth: int, seed: int = 0,
           noise: float = 0.05) -> CSR:
    """FEM/mesh-like banded matrix: nonzeros concentrated within
    ``bandwidth`` of the diagonal (normal offsets), plus a small uniform
    noise fraction."""
    rng = np.random.default_rng(seed)
    m = int(nnz * 1.2)
    n_noise = int(m * noise)
    n_band = m - n_noise
    rows = rng.integers(0, n, n_band)
    offs = np.round(rng.normal(0, bandwidth / 2.5, n_band)).astype(np.int64)
    cols = np.clip(rows + offs, 0, n - 1)
    rows = np.concatenate([rows, rng.integers(0, n, n_noise)])
    cols = np.concatenate([cols, rng.integers(0, n, n_noise)])
    return _dedup_to_csr(rows, cols, n, n)


def community(n: int, nnz: int, n_communities: int, seed: int = 0,
              p_in: float = 0.9) -> CSR:
    """Stochastic block model: node communities of random (Dirichlet)
    sizes; edges fall inside the community with probability ``p_in``,
    anywhere otherwise. Rows are shuffled so the block structure is
    latent — exactly what row reordering must rediscover."""
    rng = np.random.default_rng(seed)
    sizes = rng.dirichlet(np.ones(n_communities) * 3.0) * n
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    bounds[-1] = n
    m = int(nnz * 1.15)
    comm = rng.integers(0, n_communities, m)
    lo, hi = bounds[comm], bounds[comm + 1]
    width = np.maximum(hi - lo, 1)
    rows = lo + (rng.random(m) * width).astype(np.int64)
    inside = rng.random(m) < p_in
    cols_in = lo + (rng.random(m) * width).astype(np.int64)
    cols_out = rng.integers(0, n, m)
    cols = np.where(inside, cols_in, cols_out)
    shuffle = rng.permutation(n).astype(np.int64)
    return _dedup_to_csr(shuffle[rows], cols, n, n)


def uniform(n: int, nnz: int, seed: int = 0) -> CSR:
    """Uniform random mask — the gather-bound worst case."""
    rng = np.random.default_rng(seed)
    m = int(nnz * 1.1)
    return _dedup_to_csr(rng.integers(0, n, m), rng.integers(0, n, m), n, n)


#: The benchmark suite: 8 matrices whose REGIME MIX mirrors the
#: reference's filtered dataset (503 matrices bucketed by SuiteSparse
#: group in bsmr_sddmm_tpu/data/suitesparse_replicas.csv: 247 mesh/FEM,
#: 204 optimization/blocked, 52 graph = 49%/41%/10% -> 4/3/1 of 8), each
#: sized inside the reference's filter (m,n >= 10000, nnz >= 100000,
#: exclude_invalid_dataset.py:47). Round 1 over-weighted the adversarial
#: power-law regime (3 R-MAT + 1 uniform of 8), which the reference's
#: real dataset does not.
SUITE = (
    ("banded_mesh_32k", lambda: banded(32768, 2_000_000, 256, seed=44)),
    ("banded_mesh_64k", lambda: banded(65536, 3_500_000, 384, seed=49)),
    ("banded_mesh_20k", lambda: banded(20000, 1_200_000, 128, seed=50)),
    ("banded_mesh_12k", lambda: banded(12000, 600_000, 96, seed=45)),
    ("community_16k", lambda: community(16384, 1_200_000, 24, seed=46)),
    ("community_20k", lambda: community(20000, 900_000, 48, seed=47)),
    ("community_32k", lambda: community(32768, 1_800_000, 64, seed=51)),
    ("rmat_16", lambda: rmat(1 << 16, 1_000_000, seed=42)),
)

#: Adversarial extras kept out of the headline mix (regimes the
#: reference's dataset barely contains) — exercised by tests and
#: available to the harness by name.
EXTRA = (
    ("rmat_18", lambda: rmat(1 << 18, 2_000_000, seed=41)),
    ("rmat_14_dense", lambda: rmat(1 << 14, 1_500_000, seed=43)),
    ("uniform_20k", lambda: uniform(20000, 800_000, seed=48)),
)
