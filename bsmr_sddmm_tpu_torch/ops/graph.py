"""Graph companion ops over the CSR layout: edge softmax and SpMM.

The counterpart of ``bsmr_sddmm_tpu.ops.graph``: what a graph-attention or
sparse-transformer layer needs after the SDDMM, the row-wise softmax of the
edge scores and the weighted aggregation, over values in CSR order.
``segment_ids`` is the per-edge row vector. These are the CSR oracles that
the tile-layout ops of ``ops.graph_rphm`` are tested against.
"""

from __future__ import annotations

import numpy as np
import torch

from bsmr_sddmm_tpu_torch.formats import CSR


def csr_segment_ids(csr: CSR) -> np.ndarray:
    """Per-edge row id, aligned with CSR value order."""
    return csr.coo_rows().astype(np.int32)


def _segment_sum(vals: torch.Tensor, ids: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    out = vals.new_zeros((num_rows,) + tuple(vals.shape[1:]))
    return out.index_add(0, ids.long(), vals)


def edge_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """Numerically stable softmax over each CSR row's edge scores."""
    ids = segment_ids.long()
    row_max = scores.new_full((num_rows,), -torch.inf).scatter_reduce(
        0, ids, scores, "amax")
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    ex = torch.exp(scores - row_max[ids])
    denom = _segment_sum(ex, ids, num_rows)
    return ex / torch.clamp(denom[ids], min=1e-20)


def spmm(edge_vals: torch.Tensor, col_indices: torch.Tensor,
         segment_ids: torch.Tensor, V: torch.Tensor,
         num_rows: int) -> torch.Tensor:
    """``out[r] = sum over edges e of row r of edge_vals[e] * V[col[e]]``."""
    weighted = V.index_select(0, col_indices.long()) * edge_vals[:, None]
    return _segment_sum(weighted, segment_ids, num_rows)
