"""Reordering-quality evaluation.

A copy of ``bsmr_sddmm_tpu.evaluate`` (host only: ``bsmr`` + ``pack_tiles``),
kept in this package because importing ``bsmr_sddmm_tpu`` imports JAX; both
give the same fields for the same mask (tests/test_torch_host.py).

Port of the CUDA original's evaluationReordering (src/BSMR.cpp:826-930) and
original-matrix density statistics (src/BSMR.cpp:955-994): after the BSMR
pipeline runs, recompute per-block densities, count the blocks that meet
the delta threshold, and compare against the *un-reordered* matrix — the
number that justifies the whole reordering step. Feeds Logger extras the
way the original fills its Logger fields (BSMR.cpp:922-929).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.pack import TilePlan, pack_tiles
from bsmr_sddmm_tpu_torch.reorder import bsmr


@dataclasses.dataclass
class ReorderingEvaluation:
    """Reordered-vs-original tiling statistics at one (alpha, delta)."""

    num_dense_blocks: int          # blocks >= delta after reordering
    num_dense_blocks_original: int  # same threshold, original row order
    dense_nnz: int
    dense_nnz_original: int
    gathered_nnz: int
    residual_nnz: int
    average_density: float
    average_density_original: float
    packed_nnz: int = 0            # sub-block packed tier coverage
    num_packed_blocks: int = 0

    @property
    def dense_block_gain(self) -> float:
        """How many more threshold-passing blocks reordering found."""
        base = max(self.num_dense_blocks_original, 1)
        return self.num_dense_blocks / base

    @property
    def dense_coverage(self) -> float:
        """Fraction of nonzeros on a matmul-tile tier (BSR + packed)."""
        tiled = self.dense_nnz + self.packed_nnz
        total = tiled + self.gathered_nnz + self.residual_nnz
        return tiled / total if total else 0.0

    def as_extras(self) -> Dict[str, str]:
        """Logger extras in the original's key style."""
        return {
            "numDenseBlocksOriginal": str(self.num_dense_blocks_original),
            "denseNNZOriginal": str(self.dense_nnz_original),
            "averageDensityOriginal":
                f"{self.average_density_original:.6f}",
            "denseBlockGain": f"{self.dense_block_gain:.3f}",
            "denseCoverage": f"{self.dense_coverage:.6f}",
        }


def _tile_stats(csr: CSR, config: SddmmConfig) -> TilePlan:
    reord = bsmr(csr, config)
    return pack_tiles(csr, reord, config)


def evaluate_reordering(csr: CSR, config: SddmmConfig,
                        plan: Optional[TilePlan] = None
                        ) -> ReorderingEvaluation:
    """Compare the reordered tiling against the identity ordering at the
    same (alpha, delta) thresholds (original evaluationReordering +
    BSMR.cpp:955-994)."""
    if plan is None:
        plan = _tile_stats(csr, config)
    base = _tile_stats(csr, config.replace(row_strategy="none"))
    # original semantics: num_dense_blocks counts blocks MEETING DELTA
    # (the dense tier; BSMR.cpp:826-930). The packed sub-block tier is
    # reported separately — with it enabled, reordering quality shows up
    # as HIGHER average density / fewer tiles for the same coverage, not
    # necessarily more blocks.
    return ReorderingEvaluation(
        num_dense_blocks=plan.num_tiles,
        num_dense_blocks_original=base.num_tiles,
        dense_nnz=plan.dense_nnz,
        dense_nnz_original=base.dense_nnz,
        gathered_nnz=plan.gathered_nnz,
        residual_nnz=plan.residual_nnz,
        average_density=plan.average_tile_density,
        average_density_original=base.average_tile_density,
        packed_nnz=plan.packed_nnz,
        num_packed_blocks=plan.num_packed,
    )
