"""Public SpMM over a BSMR-packed mask: ``out = S @ V``.

The counterpart of ``bsmr_sddmm_tpu.ops.spmm``. The CSR matrix's values are
scattered once into the plan's rphm layout on the host
(:func:`pack_values_rphm`, a copy of the JAX package's), and every call is
the tile-layout aggregation of ``ops.graph_rphm.make_spmm_rphm``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.ops.graph_rphm import make_spmm_rphm
from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan, resolve_device
from bsmr_sddmm_tpu_torch.pack import TilePlan


def pack_values_rphm(plan: TilePlan, values: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """Scatter CSR-order values into the plan's four-tier rphm layout
    (host side, once per value set). Trash/pad slots become zero."""
    v = np.concatenate([np.asarray(values, np.float32), [0.0]])
    dense = v[plan.tile_scatter]        # (T, ph, bw)
    packed = (v[plan.sp_scatter]
              if plan.sp_scatter is not None and plan.sp_scatter.size
              else np.zeros((0, plan.panel_height, plan.block_width),
                            np.float32))
    gathered = v[plan.g_scatter]        # (Tg, ph, bw)
    res = v[plan.res_out]               # (E,)
    return dense, packed, gathered, res


#: the JAX package's name for the tile-layout SpMM builder (values from
#: :func:`pack_values_rphm` or an SDDMM or softmax in the rphm layout)
make_spmm_fn = make_spmm_rphm


def spmm(csr: CSR, plan: TilePlan, V: np.ndarray, device=None) -> np.ndarray:
    """One-shot ``csr @ V`` through the packed plan (values =
    ``csr.values``), on the CUDA device unless ``device`` says otherwise."""
    device = resolve_device(device)
    tiers = [torch.from_numpy(t).to(device)
             for t in pack_values_rphm(plan, csr.values)]
    V_t = torch.as_tensor(np.asarray(V, np.float32)).to(device)
    out = make_spmm_fn(plan)(*tiers, V_t, device_plan(plan, device))
    return out.cpu().numpy()
