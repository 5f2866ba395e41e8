"""Reordering result cache.

A copy of ``bsmr_sddmm_tpu.cache`` (plain NumPy), kept in this package
because importing ``bsmr_sddmm_tpu`` imports JAX. Both packages use the
same key, the same ``.npz`` format and the same ``BSMR_CACHE_DIR``, so an
entry that one package writes loads in the other
(tests/test_torch_host.py).

Row clustering dominates preprocessing, and its result depends only on
(mask pattern, alpha, strategy, encoding_block). Caching it on disk lets a
re-run sweep (or a crashed one) skip straight to the cheap
column-split/packing stages.

Cache key: SHA-256 over the CSR pattern (shape, row_offsets, col_indices)
plus the clustering knobs. Entries are ``.npz`` files under the cache dir:
``BSMR_CACHE_DIR`` or, when that is unset, ``build/reorder_cache`` at the
root of the checkout (gitignored).
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Optional

import numpy as np

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.reorder import BsmrReordering, row_reordering


def cache_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = os.environ.get("BSMR_CACHE_DIR") or os.path.join(
        root, "build", "reorder_cache")
    os.makedirs(d, exist_ok=True)
    return d


def pattern_digest(csr: CSR) -> str:
    """Digest of the mask *pattern* (values don't affect reordering)."""
    h = hashlib.sha256()
    h.update(np.asarray([csr.rows, csr.cols, csr.nnz], np.int64).tobytes())
    h.update(np.ascontiguousarray(csr.row_offsets, np.int64).tobytes())
    h.update(np.ascontiguousarray(csr.col_indices, np.int32).tobytes())
    return h.hexdigest()[:24]


def _key(csr: CSR, alpha: float, config: SddmmConfig) -> str:
    return (f"{pattern_digest(csr)}_a{alpha:g}_s{config.row_strategy}"
            f"_e{config.encoding_block}")


def load_reordering(csr: CSR, alpha: float,
                    config: SddmmConfig) -> Optional[BsmrReordering]:
    path = os.path.join(cache_dir(), _key(csr, alpha, config) + ".npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return BsmrReordering(
                row_perm=z["row_perm"],
                cluster_ids=z["cluster_ids"],
                num_clusters=int(z["num_clusters"]),
                row_time_ms=float(z["row_time_ms"]),
            )
    except (OSError, KeyError, ValueError):
        return None


def store_reordering(csr: CSR, alpha: float, config: SddmmConfig,
                     reord: BsmrReordering) -> str:
    path = os.path.join(cache_dir(), _key(csr, alpha, config) + ".npz")
    # suffix must be .npz: np.savez appends it otherwise
    fd, tmp = tempfile.mkstemp(dir=cache_dir(), suffix=".tmp.npz")
    os.close(fd)
    np.savez_compressed(tmp, row_perm=reord.row_perm,
                        cluster_ids=reord.cluster_ids,
                        num_clusters=reord.num_clusters,
                        row_time_ms=reord.row_time_ms)
    os.replace(tmp, path)
    return path


def cached_row_reordering(csr: CSR, alpha: float,
                          config: SddmmConfig) -> BsmrReordering:
    """row_reordering with a disk cache (used when
    ``config.reorder_cache`` is on)."""
    hit = load_reordering(csr, alpha, config)
    if hit is not None:
        return hit
    reord = row_reordering(csr, alpha, config)
    store_reordering(csr, alpha, config, reord)
    return reord
