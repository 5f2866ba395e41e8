"""Configuration for the BSMR-SDDMM pipeline on PyTorch.

The same fields, defaults and validation as ``bsmr_sddmm_tpu.config``, so
that one ``SddmmConfig(...)`` call builds either package's config
(``interop.config_from_reference`` converts an existing one). The CUDA
original exposes its knobs as CLI flags (-f/-k/-a/-d/-t/-l,
include/Options.hpp:38-43) plus compile-time tile macros; here every knob is
a runtime dataclass field.

Fields that only steer XLA in the JAX package are kept for parity and are
not read by this package: ``tier_serialize``, ``tier_memory_mb`` and
``residual_chunk`` (beyond bucketing the residual length in ``pack``), and
``matmul_precision`` (every tier here accumulates in full fp32).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SddmmConfig:
    """All knobs for one BSMR-SDDMM run.

    Defaults mirror the CUDA original's (K=32, alpha=0.3, delta=0.3,
    include/Options.hpp:38-43) except for tile geometry.
    """

    # --- problem shape ---------------------------------------------------
    k: int = 32                  # contraction dim (original -k)
    alpha: float = 0.3           # row-similarity threshold (original -a)
    delta: float = 0.3           # block-density threshold (original -d)

    # --- tile geometry ----------------------------------------------------
    # Row-panel height: rows of one output tile. Larger panels raise the
    # reuse of each B column but dilute tile density.
    panel_height: int = 32
    # Column-block width: columns of one output tile.
    block_width: int = 128
    # Column-block granularity of the row-pattern *encoding* used for
    # clustering (original COL_BLOCK_SIZE=32, src/rowReordering.cu:13).
    encoding_block: int = 32

    # --- numerics ---------------------------------------------------------
    # Accepted for parity with the JAX package, which splits fp32 operands
    # into bf16 passes; this package computes every tier in fp32 and does
    # not read it.
    matmul_precision: str = "bf16x3"  # "default" | "bf16x3" | "highest"
    dtype: str = "float32"
    # Output value dtype. "float16" halves the output bytes of every tier
    # (accumulation stays fp32, only the store narrows) and still passes
    # the tolerance (fp16 round-off is rel ~5e-4 < the 1e-3 rel gate,
    # include/checkData.hpp:14-30).
    out_dtype: str = "float32"   # "float32" | "float16"

    # --- column split mode --------------------------------------------------
    # "bsr"     : no column permutation: dense tiles are the natural
    #             block_width-wide column blocks whose in-panel nnz meets
    #             the delta threshold, so each tile's B operand is a
    #             contiguous slice of B^T.
    # "reorder" : the original's per-panel column reordering
    #             (src/colReordering.cu:274-404): each dense tile's bw
    #             columns are an arbitrary list (tile_cols), and the dense
    #             tier runs dense_kernels.dense_tile, which reads those B
    #             rows by index inside the kernel.
    col_mode: str = "bsr"

    # --- reordering strategy ----------------------------------------------
    # "exact"  : faithful greedy accumulate-encoding clustering
    #            (src/rowReordering.cu:325-432 semantics), sequential host.
    # "fast"   : greedy with one representative per round, the similarity
    #            scan vectorized over all remaining rows.
    # "none"   : identity ordering (original noReorderRow,
    #            src/rowReordering.cu:15-46).
    row_strategy: str = "fast"
    # Use the C++/OpenMP clustering (bsmr_sddmm_tpu_torch.native) when it
    # can be built; same semantics as the NumPy strategies.
    use_native: bool = True
    # On-disk cache of row reorderings (bsmr_sddmm_tpu_torch.cache; the
    # same files as the JAX package's, under BSMR_CACHE_DIR).
    reorder_cache: bool = False

    # --- residual packing ---------------------------------------------------
    # What happens to nonzeros outside dense tiles. "gathered": each panel's
    # residual columns (count-descending) pack into block_width-wide
    # *gathered* tiles, computed as a batched matmul against gathered B
    # rows, while chunks too sparse to fill a tile fall back to per-nonzero
    # gather-dot; "pernnz": everything per-nonzero.
    residual_mode: str = "gathered"   # "gathered" | "pernnz"
    # Gathered-tile execution arm. "xla": one row gather + batched matmul
    # (plain torch here). "fused": dense_kernels.fused_gathered, which reads
    # each tile's B rows by index inside the kernel; like the JAX package,
    # windowed plans (g_groups) keep the "xla" arm.
    gathered_backend: str = "xla"     # "xla" | "fused"
    # Tier scheduling barrier of the JAX package's XLA program; not read.
    tier_serialize: object = "auto"   # "auto" | "on" | "off" | bool
    # Minimum nonzeros a gathered block_width-column chunk must cover to
    # become a tile (the reference's tuned crossover, kept so that plans
    # match it).
    residual_tile_min_nnz: int = 96

    # --- sub-block packed tier ------------------------------------------
    # Qualifying subblock_width-wide *aligned* column sub-blocks of the same
    # row panel (in a hot-column permuted space) are packed
    # S = block_width/subblock_width side by side into one tile, whose B
    # operand is S contiguous (subblock_width x K) slices of the permuted
    # B^T. Entries land here when their (panel, sub-block) count reaches
    # subpack_min_nnz and the enclosing block did NOT meet delta. 0
    # disables the tier.
    subblock_width: int = 32
    subpack_min_nnz: int = 12
    # B-gather windowing of the JAX package: when B exceeds
    # gather_window_threshold_mb, gathered tiles and residual entries are
    # grouped by column window at pack time. Kept so that plans match the
    # reference's; this package gathers by absolute index, which gives the
    # same values. 0 disables.
    gather_window_mb: int = 16
    gather_window_threshold_mb: int = 64
    # Cap on window groups per side per tier.
    max_gather_groups: int = 48

    # Max dense tiles fused per step in bsr mode ("fat steps"): G
    # same-column-block tiles share one B block. The packer picks G over
    # the plan's same-cblock run lengths. 1 disables.
    dense_fat_group: int = 32

    # --- execution --------------------------------------------------------
    # "auto"  : hand kernels for CUDA tensors, their plain PyTorch versions
    #           for CPU tensors.
    # "torch" : the plain PyTorch versions on any device (comparisons).
    backend: str = "auto"
    # Tile counts are padded to multiples of this chunk (pack.exec_size).
    dense_chunk: int = 512
    # Residual entry counts are padded to multiples of this chunk.
    residual_chunk: int = 1 << 16
    # Live-intermediate budget of the JAX package's XLA tiers; not read.
    tier_memory_mb: int = 384
    # Pad tile/residual counts up to buckets (powers of two between
    # min_bucket and exact).
    bucket_shapes: bool = True

    # --- benchmark --------------------------------------------------------
    num_iterations: int = 10     # timing iterations (original Options.hpp:39)
    # alpha="auto": re-time this many of the best-priced plans on the card
    # and pick the measured argmin (autotune.choose_config); 0 or 1 keeps
    # the cost model's pick.
    autotune_refine_top: int = 0

    def __post_init__(self) -> None:
        if self.k % 8 != 0:
            raise ValueError(f"k must be a multiple of 8, got {self.k}")
        if self.panel_height % 8 != 0:
            raise ValueError(
                f"panel_height must be a multiple of 8, got "
                f"{self.panel_height}"
            )
        if self.block_width % 128 != 0:
            raise ValueError(
                f"block_width must be a multiple of 128, got "
                f"{self.block_width}"
            )
        if self.row_strategy not in ("exact", "fast", "none"):
            raise ValueError(f"unknown row_strategy {self.row_strategy!r}")
        if self.subpack_min_nnz and (
                self.subblock_width <= 0
                or self.block_width % self.subblock_width):
            raise ValueError(
                f"subblock_width ({self.subblock_width}) must divide "
                f"block_width ({self.block_width})")
        if self.col_mode not in ("bsr", "reorder"):
            raise ValueError(f"unknown col_mode {self.col_mode!r}")
        if self.residual_mode not in ("gathered", "pernnz"):
            raise ValueError(
                f"unknown residual_mode {self.residual_mode!r}")
        if self.gathered_backend not in ("xla", "fused"):
            raise ValueError(
                f"unknown gathered_backend {self.gathered_backend!r}")
        if self.tier_serialize not in ("auto", "on", "off", True, False):
            raise ValueError(
                f"unknown tier_serialize {self.tier_serialize!r}")
        if self.backend not in ("auto", "torch"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.matmul_precision not in ("default", "bf16x3", "high",
                                         "highest"):
            raise ValueError(
                f"unknown matmul_precision {self.matmul_precision!r}"
            )
        if self.out_dtype not in ("float32", "float16"):
            raise ValueError(f"unknown out_dtype {self.out_dtype!r}")

    @property
    def block_size(self) -> int:
        """Elements per dense tile (original BLOCK_SIZE=256, BSMR.hpp:10)."""
        return self.panel_height * self.block_width

    def replace(self, **kw) -> "SddmmConfig":
        return dataclasses.replace(self, **kw)


# Sweep grids for test mode. Alphas and Ks mirror the CUDA original
# (src/sddmm.cu:64-66); the delta grid is the JAX package's, which prepends
# low deltas (0.006/0.02/0.05) to the original grid.
SWEEP_ALPHAS = (0.1, 0.3, 0.5, 0.7, 0.9)
SWEEP_DELTAS = (0.006, 0.02, 0.05, 0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.1)
SWEEP_KS = (32, 64, 128, 256)
