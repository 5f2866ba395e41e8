"""bsmr_sddmm_tpu_torch — the BSMR-SDDMM framework on PyTorch and CUDA.

The port of ``bsmr_sddmm_tpu`` (JAX/Pallas) to an NVIDIA Hopper GPU. It
computes ``P = (A @ B) * S`` only where the sparse mask ``S`` is nonzero,
by

1. reordering the mask's rows by pattern similarity (threshold ``alpha``),
2. splitting each row panel into dense tiles (density threshold
   ``delta``: natural column blocks, or per-panel reordered column groups
   with ``col_mode="reorder"``), hot-column packed tiles, gathered tiles
   and a per-nonzero residual,
3. running the tile tiers through hand-written CUDA kernels for ``sm_90a``
   (``ops/dense_kernels.py``, ``csrc/``) and the rest as torch ops.

The host layers (formats, reorder, pack) are NumPy copies of the JAX
package's, because importing anything from ``bsmr_sddmm_tpu`` imports JAX;
this package never imports ``jax``.

Layer map:

    CLI / driver       bsmr_sddmm_tpu_torch.cli
    orchestration      bsmr_sddmm_tpu_torch.sddmm (BsmrSddmm pipeline)
    preprocessing      bsmr_sddmm_tpu_torch.reorder, .pack, .native
    compute            bsmr_sddmm_tpu_torch.ops (body, CUDA kernels)
    data layer         bsmr_sddmm_tpu_torch.formats, .datasets
"""

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR, COO, load_matrix, make_dense
from bsmr_sddmm_tpu_torch.reorder import (BsmrReordering, row_reordering,
                                          col_reordering)
from bsmr_sddmm_tpu_torch.pack import TilePlan, pack_tiles
from bsmr_sddmm_tpu_torch.sddmm import BsmrSddmm, sddmm

__version__ = "0.1.0"

__all__ = [
    "SddmmConfig",
    "CSR",
    "COO",
    "load_matrix",
    "make_dense",
    "BsmrReordering",
    "row_reordering",
    "col_reordering",
    "TilePlan",
    "pack_tiles",
    "BsmrSddmm",
    "sddmm",
    "__version__",
]
