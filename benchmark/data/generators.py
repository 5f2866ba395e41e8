"""Frozen mask generators of the benchmark.

Copies of the port's synthetic SuiteSparse-regime generators
(``bsmr_sddmm_tpu_torch.datasets``: ``banded``, ``community``, ``rmat``,
``uniform``, ``_dedup_to_csr``; ``replicas.make_replica``, the
shape-matched replica of a named matrix), kept here so that a change to the
program cannot change the masks the benchmark measures. Each returns a
:class:`Mask` (CSR structure, values all 1).
``benchmark/tests/test_bench_data.py`` holds them bit for bit against the
port's ``datasets.SUITE`` and ``replicas``.

A configuration may also name a generator of a file of its own,
``benchmark/data/masks/<generator>.py`` (``spec.mask_generator``), which a
later configuration adds without an edit here; its ``EXAMPLE_SHA256``, the
:func:`digest` of its ``EXAMPLE``'s mask, holds it frozen in the same way.

Operands follow the original's ``Matrix::makeData`` convention, uniform
[0, 2) (the port's ``formats.make_dense``); the benchmark draws them on the
card from ``--seed`` (``loadgen.make_ring``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

from benchmark.spec import ROOT, mask_generator


@dataclasses.dataclass(frozen=True)
class Mask:
    """A sparse mask in CSR form: ``row_offsets`` (rows + 1,) int64,
    ``col_indices`` (nnz,) int32, columns ascending within a row."""

    rows: int
    cols: int
    row_offsets: np.ndarray
    col_indices: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.col_indices.shape[0])

    def coo_rows(self) -> np.ndarray:
        """The row of every nonzero, in CSR order (int64)."""
        return np.repeat(np.arange(self.rows, dtype=np.int64),
                         np.diff(self.row_offsets))


def _dedup_to_csr(rows, cols, n_rows, n_cols) -> Mask:
    keys = rows.astype(np.int64) * np.int64(n_cols) + cols.astype(np.int64)
    uniq = np.unique(keys)
    ri = uniq // n_cols
    ci = (uniq % n_cols).astype(np.int32)
    row_offsets = np.zeros(n_rows + 1, dtype=np.int64)
    row_offsets[1:] = np.cumsum(np.bincount(ri, minlength=n_rows))
    return Mask(n_rows, n_cols, row_offsets, ci)


def rmat(n: int, nnz: int, seed: int = 0, a: float = 0.57,
         b: float = 0.19, c: float = 0.19) -> Mask:
    """R-MAT / Kronecker graph with the Graph500 quadrant probabilities."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    m = int(nnz * 1.15)
    rows = np.zeros(m, np.int64)
    cols = np.zeros(m, np.int64)
    for _ in range(scale):
        r = rng.random(m)
        row_bit = (r >= a + b).astype(np.int64)
        col_bit = (((r >= a) & (r < a + b))
                   | (r >= a + b + c)).astype(np.int64)
        rows = (rows << 1) | row_bit
        cols = (cols << 1) | col_bit
    keep = (rows < n) & (cols < n)
    return _dedup_to_csr(rows[keep], cols[keep], n, n)


def banded(n: int, nnz: int, bandwidth: int, seed: int = 0,
           noise: float = 0.05) -> Mask:
    """FEM/mesh-like banded mask: normal offsets within ``bandwidth`` of
    the diagonal, plus a uniform noise fraction."""
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
              p_in: float = 0.9) -> Mask:
    """Stochastic block model with Dirichlet community sizes; rows are
    shuffled, so the block structure is latent."""
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


def uniform(n: int, nnz: int, seed: int = 0) -> Mask:
    """Uniform random mask: the gather-bound worst case."""
    rng = np.random.default_rng(seed)
    m = int(nnz * 1.1)
    return _dedup_to_csr(rng.integers(0, n, m), rng.integers(0, n, m), n, n)


def _seed_of(name: str) -> int:
    """A replica's seed, from its matrix's name (stable across processes)."""
    import zlib
    return (zlib.crc32(name.encode()) & 0x7FFFFFFF) or 1


def _banded_rect(m: int, n: int, nnz: int, seed: int) -> Mask:
    """Banded mask around the scaled diagonal (FEM/mesh regime)."""
    rng = np.random.default_rng(seed)
    deg = max(nnz / max(m, 1), 1.0)
    bandwidth = max(int(deg * 1.5), 8)
    over = int(nnz * 1.25)
    rows = rng.integers(0, m, over)
    centers = (rows.astype(np.float64) * n / m)
    offs = rng.normal(0, bandwidth / 2.5, over) * (n / max(m, 1))
    cols = np.clip(np.round(centers + offs), 0, n - 1).astype(np.int64)
    noise = max(int(over * 0.03), 1)
    rows[:noise] = rng.integers(0, m, noise)
    cols[:noise] = rng.integers(0, n, noise)
    return _dedup_to_csr(rows, cols, m, n)


def _community_rect(m: int, n: int, nnz: int, seed: int) -> Mask:
    """Latent row/column communities of random sizes (LP/optimisation
    regime)."""
    rng = np.random.default_rng(seed)
    n_comm = int(np.clip(np.sqrt(min(m, n)) / 3, 6, 64))
    row_comm = rng.integers(0, n_comm, m)
    sizes = rng.dirichlet(np.ones(n_comm) * 3.0)
    col_bounds = np.concatenate([[0], np.cumsum(sizes)]) * n
    col_bounds = col_bounds.astype(np.int64)
    col_bounds[-1] = n
    over = int(nnz * 1.25)
    rows = rng.integers(0, m, over)
    c_of_r = row_comm[rows]
    inside = rng.random(over) < 0.85
    lo = col_bounds[c_of_r]
    hi = np.maximum(col_bounds[c_of_r + 1], lo + 1)
    cols = np.where(inside,
                    lo + (rng.random(over) * (hi - lo)).astype(np.int64),
                    rng.integers(0, n, over))
    return _dedup_to_csr(rows, np.minimum(cols, n - 1), m, n)


def _rmat_rect(m: int, n: int, nnz: int, seed: int) -> Mask:
    """Power-law graph (SNAP/web regime), cropped to (m, n)."""
    side = max(m, n)
    target = max(int(nnz * (side / m) * (side / n)), nnz)
    square = rmat(side, target, seed=seed)
    rows = square.coo_rows()
    cols = square.col_indices
    keep = (rows < m) & (cols < n)
    if keep.sum() < nnz * 0.2:
        rng = np.random.default_rng(seed)
        deg = rng.zipf(1.7, n).astype(np.float64)
        p = deg / deg.sum()
        over = int(nnz * 1.2)
        return _dedup_to_csr(rng.integers(0, m, over),
                             rng.choice(n, size=over, p=p), m, n)
    return _dedup_to_csr(rows[keep].astype(np.int64),
                         cols[keep].astype(np.int64), m, n)


def _block_diag_rect(m: int, n: int, nnz: int, seed: int,
                     fill: float = 0.85, noise: float = 0.02) -> Mask:
    """Small dense diagonal blocks (the TSOPF power-flow family)."""
    rng = np.random.default_rng(seed)
    deg = max(nnz / max(m, 1), 2.0)
    b = int(np.clip(round(deg / fill), 4, 2048))
    n_blocks = max(m // b, 1)
    per_block = int(nnz * (1.0 - noise)) // n_blocks
    bp = max(int(round(b * n / m)), 1)
    cells = b * bp
    frac = min(per_block / cells, 0.95)
    over = max(int(-cells * np.log1p(-frac)), 1)
    rows_list, cols_list = [], []
    for i in range(n_blocks):
        r0 = i * b
        c0 = min(int(i * b * n / m), max(n - bp, 0))
        rows_list.append(r0 + rng.integers(0, min(b, m - r0), over))
        cols_list.append(c0 + rng.integers(0, min(bp, n - c0), over))
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    n_noise = max(int(nnz * noise), 1)
    rows = np.concatenate([rows, rng.integers(0, m, n_noise)])
    cols = np.concatenate([cols, rng.integers(0, n, n_noise)])
    return _dedup_to_csr(rows.astype(np.int64), cols.astype(np.int64),
                         m, n)


def replica(name: str, group: str, regime: str, m: int, n: int,
            nnz: int) -> Mask:
    """The shape-matched replica of one SuiteSparse matrix of the
    original's evaluation, from its published row (name, group, regime, M,
    N, NNZ): the port's ``replicas.make_replica``, frozen. The structure is
    the regime's generator, seeded from the name; only M and N are the
    matrix's own, and the nonzeros come out near NNZ."""
    if regime == "opt" and (group == "TSOPF" or name.startswith("TSOPF")):
        return _block_diag_rect(m, n, nnz, _seed_of(name))
    make = {"mesh": _banded_rect, "opt": _community_rect,
            "graph": _rmat_rect}[regime]
    return make(m, n, nnz, _seed_of(name))


GENERATORS = {"banded": banded, "community": community, "rmat": rmat,
              "uniform": uniform, "replica": replica}


def make_mask(spec: dict, root: str = ROOT) -> Mask:
    """The mask a configuration file's ``mask`` entry names:
    ``{"generator": <name>, <its keyword arguments>}``, where the name is
    one of ``GENERATORS`` or else of a generator file of the benchmark at
    ``root``."""
    kwargs = dict(spec)
    name = kwargs.pop("generator")
    if name in GENERATORS:
        return GENERATORS[name](**kwargs)
    return mask_generator(name, root).make(**kwargs)


def digest(mask: Mask) -> str:
    """The SHA-256 of a mask's shape, ``row_offsets`` (int64) and
    ``col_indices`` (int32), as a generator file's ``EXAMPLE_SHA256``
    records it."""
    h = hashlib.sha256(np.array([mask.rows, mask.cols], "<i8").tobytes())
    h.update(np.ascontiguousarray(mask.row_offsets, "<i8").tobytes())
    h.update(np.ascontiguousarray(mask.col_indices, "<i4").tobytes())
    return h.hexdigest()


#: bump when a generator's output changes, so that no stale file is read
CACHE_VERSION = 1


def cached_mask(spec: dict, cache_dir: str, root: str = ROOT) -> Mask:
    """``make_mask(spec, root)``, kept as a ``.npz`` under ``cache_dir``
    (inside the checkout) after the first run, since the mask is the
    deployment and does not change with the seed."""
    key = hashlib.sha256(json.dumps([CACHE_VERSION, spec], sort_keys=True)
                         .encode()).hexdigest()[:16]
    path = os.path.join(cache_dir, f"mask-{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return Mask(int(z["shape"][0]), int(z["shape"][1]),
                        z["row_offsets"], z["col_indices"])
    mask = make_mask(spec, root)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(tmp, shape=np.array([mask.rows, mask.cols]),
             row_offsets=mask.row_offsets, col_indices=mask.col_indices)
    os.replace(tmp, path)
    return mask
