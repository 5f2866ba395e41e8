"""Shape-matched replicas of the reference's SuiteSparse dataset.

A copy of ``bsmr_sddmm_tpu.replicas`` on this package's ``datasets`` and
``datatools``: the same spec gives the same CSR, bit for bit.

The reference commits per-matrix results for 503 SuiteSparse matrices
(scripts/results_suiteSparse_dataset/k*/results_*.csv). The tarballs are
not downloaded, but the committed CSVs carry each matrix's (M, N, NNZ) and
the download script its SuiteSparse *group* — enough to generate a
structurally matched replica per matrix:

  group -> regime -> generator
  mesh  (FEM/structural: HB, Boeing, Oberwolfach, ...) -> banded
  opt   (LP/optimization: Hollinger, Meszaros, TSOPF, ...) -> community
        (block-structured with latent irregular clusters)
  graph (SNAP, DIMACS10, Pajek, ...) -> R-MAT power law

The manifest (bsmr_sddmm_tpu_torch/data/suitesparse_replicas.csv, a
byte-identical copy of the JAX package's, generated by
scripts/make_replica_manifest.py) also carries the reference's measured
best-BSMR GFLOPS per K — the per-matrix numbers to beat.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

from bsmr_sddmm_tpu_torch.datasets import _dedup_to_csr
from bsmr_sddmm_tpu_torch.formats import CSR

_MANIFEST = os.path.join(os.path.dirname(__file__), "data",
                         "suitesparse_replicas.csv")


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    name: str
    group: str
    regime: str            # mesh | opt | graph
    m: int
    n: int
    nnz: int
    ref_bsmr_gflops: Dict[int, float]   # K -> reference best GFLOPS
    # 16x16-tile structure of the REAL matrix, from the reference's own
    # BSMR run (K=128 a=0.3 d=0.3 log): dense coverage = numDenseData /
    # NNZ, and average dense-block density — replica fidelity targets
    ref_dense_coverage: Optional[float] = None
    ref_avg_density: Optional[float] = None


def load_manifest(path: str = _MANIFEST) -> List[ReplicaSpec]:
    specs = []
    with open(path) as f:
        for rec in csv.DictReader(f):
            ref = {}
            for k in (32, 64, 128, 256):
                v = rec.get(f"ref_bsmr_gflops_k{k}", "")
                if v:
                    ref[k] = float(v)
            cov = rec.get("ref_dense_coverage", "")
            den = rec.get("ref_avg_density", "")
            specs.append(ReplicaSpec(
                name=rec["name"], group=rec["group"],
                regime=rec["regime"], m=int(rec["M"]), n=int(rec["N"]),
                nnz=int(rec["NNZ"]), ref_bsmr_gflops=ref,
                ref_dense_coverage=float(cov) if cov else None,
                ref_avg_density=float(den) if den else None))
    return specs


def _seed_of(name: str) -> int:
    # zlib.crc32 is stable across processes (Python's hash() is salted by
    # PYTHONHASHSEED, which would make every subprocess of a suite run
    # generate a *different* replica for the same name)
    import zlib
    return (zlib.crc32(name.encode()) & 0x7FFFFFFF) or 1


def _banded_rect(m: int, n: int, nnz: int, seed: int) -> CSR:
    """Banded mask around the scaled diagonal (FEM/mesh regime),
    rectangular-capable."""
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


def _community_rect(m: int, n: int, nnz: int, seed: int) -> CSR:
    """Latent block structure with shuffled rows (LP/optimization
    regime): row/col community assignments of random sizes."""
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


def _rmat_rect(m: int, n: int, nnz: int, seed: int) -> CSR:
    """Power-law graph (SNAP/web regime), cropped to (m, n)."""
    from bsmr_sddmm_tpu_torch.datasets import rmat
    side = max(m, n)
    # aim so the (m, n) crop keeps ~nnz entries
    target = max(int(nnz * (side / m) * (side / n)), nnz)
    csr = rmat(side, target, seed=seed)
    rows = csr.coo_rows()
    cols = csr.col_indices
    keep = (rows < m) & (cols < n)
    if keep.sum() < nnz * 0.2:   # extreme aspect ratios: fall back
        rng = np.random.default_rng(seed)
        deg = rng.zipf(1.7, n).astype(np.float64)
        p = deg / deg.sum()
        over = int(nnz * 1.2)
        return _dedup_to_csr(rng.integers(0, m, over),
                             rng.choice(n, size=over, p=p), m, n)
    return _dedup_to_csr(rows[keep].astype(np.int64),
                         cols[keep].astype(np.int64), m, n)


def _block_diag_rect(m: int, n: int, nnz: int, seed: int,
                     fill: float = 0.85, noise: float = 0.02) -> CSR:
    """Block-diagonal mask with small dense blocks (the TSOPF power-flow
    family: the reference's own run measures ~0.81 dense coverage at
    16x16/delta 0.3 on these — a generic community generator misses
    that structure entirely). Block size derives from the average
    degree so nnz and shape match the spec."""
    rng = np.random.default_rng(seed)
    deg = max(nnz / max(m, 1), 2.0)
    b = int(np.clip(round(deg / fill), 4, 2048))
    n_blocks = max(m // b, 1)
    # dense entries inside diagonal blocks
    target_in = int(nnz * (1.0 - noise))
    per_block = target_in // n_blocks
    rows_list = []
    cols_list = []
    # sample inside each b x b' block; uniform sampling loses unique
    # entries to collisions, so draw the collision-corrected count
    # (expected uniques of d draws over c cells = c*(1-exp(-d/c)))
    bp = max(int(round(b * n / m)), 1)       # column-side block size
    cells = b * bp
    frac = min(per_block / cells, 0.95)
    over = max(int(-cells * np.log1p(-frac)), 1)
    for i in range(n_blocks):
        r0 = i * b
        c0 = min(int(i * b * n / m), max(n - bp, 0))
        rr = r0 + rng.integers(0, min(b, m - r0), over)
        cc = c0 + rng.integers(0, min(bp, n - c0), over)
        rows_list.append(rr)
        cols_list.append(cc)
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    n_noise = max(int(nnz * noise), 1)
    rows = np.concatenate([rows, rng.integers(0, m, n_noise)])
    cols = np.concatenate([cols, rng.integers(0, n, n_noise)])
    return _dedup_to_csr(rows.astype(np.int64), cols.astype(np.int64),
                         m, n)


_GENERATORS = {"mesh": _banded_rect, "opt": _community_rect,
               "graph": _rmat_rect}


def make_replica(spec: ReplicaSpec) -> CSR:
    """Generate the structurally matched replica for one manifest row
    (values all 1, like the reference's normalized dataset). TSOPF-family
    opt matrices get the block-diagonal generator; other opt matrices
    the latent-community one."""
    if spec.regime == "opt" and (spec.group == "TSOPF"
                                 or spec.name.startswith("TSOPF")):
        return _block_diag_rect(spec.m, spec.n, spec.nnz,
                                _seed_of(spec.name))
    return _GENERATORS[spec.regime](spec.m, spec.n, spec.nnz,
                                    _seed_of(spec.name))


def make_replica_cached(spec: ReplicaSpec, cache_dir: str) -> CSR:
    """make_replica with an npz disk cache: generation of a multi-M-nnz
    replica costs seconds of the single host core, which an in-process
    device sweep pays on its critical path; the generators are
    deterministic (crc32-of-name seeds), so a cached copy is identical.
    Used by the replica suite runner and the prewarm script."""
    import os
    path = os.path.join(cache_dir, f"{spec.name}.npz")
    if os.path.exists(path):
        from bsmr_sddmm_tpu_torch.datatools import load_npz
        try:
            return load_npz(path)
        except (OSError, KeyError, ValueError):
            pass   # corrupt/partial cache entry: regenerate
    csr = make_replica(spec)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, rows=csr.rows, cols=csr.cols,
             row_offsets=csr.row_offsets,
             col_indices=csr.col_indices, values=csr.values)
    os.replace(tmp, path)
    return csr


def select_suite(specs: Optional[List[ReplicaSpec]] = None,
                 count: int = 36,
                 max_nnz: int = 30_000_000) -> List[ReplicaSpec]:
    """Pick a representative subset: per regime, proportional to the
    reference's regime mix, spread evenly across the nnz range."""
    specs = specs if specs is not None else load_manifest()
    specs = [s for s in specs if s.nnz <= max_nnz]
    by_regime: Dict[str, List[ReplicaSpec]] = {}
    for s in specs:
        by_regime.setdefault(s.regime, []).append(s)
    total = sum(len(v) for v in by_regime.values())
    picked = []
    for regime, group in sorted(by_regime.items()):
        group.sort(key=lambda s: s.nnz)
        want = max(1, -(-count * len(group) // total))  # ceil
        idx = np.linspace(0, len(group) - 1, want).astype(int)
        picked.extend(group[i] for i in sorted(set(idx)))
    # linspace dedup can undershoot on small regime groups: top up with
    # unpicked specs nearest the middle of the nnz range
    if len(picked) < count:
        chosen = {s.name for s in picked}
        rest = [s for s in specs if s.name not in chosen]
        rest.sort(key=lambda s: s.nnz)
        step = max(len(rest) // max(count - len(picked), 1), 1)
        picked.extend(rest[::step][:count - len(picked)])
    return sorted(picked, key=lambda s: s.nnz)
