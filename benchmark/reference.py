"""The plain reference of the benchmark and the comparison that decides
``correct``.

``sddmm_fp64`` computes ``P[i] = sum_k A[row_i, k] * B[col_i, k]`` at every
nonzero of the mask, in CSR order, in float64, with plain torch ops, in
blocks of nonzeros so that it fits beside the operands. It works from the
mask and the operands that the benchmark made, never from anything the
program derived from them. It imports nothing of the program.

``max_rel_err`` is the number compared: over every nonzero,
``|P_program - P_ref| / (|A| . |B|)`` at that nonzero, the error of a dot
product measured against the sum of the magnitudes of its terms, so that it
reads alike on any operand signs and at any K.
"""

from __future__ import annotations

import numpy as np
import torch

#: nonzeros a block of the reference gathers at once
BLOCK = 1 << 18


def sddmm_fp64(A: torch.Tensor, Bt: torch.Tensor, rows: torch.Tensor,
               cols: torch.Tensor, block: int = BLOCK):
    """(P, S) in float64 on A's device: P the sampled product at every
    (rows[i], cols[i]), S the sum of |a_k| * |b_k| there. ``A`` is (M, K),
    ``Bt`` (N, K); ``rows`` and ``cols`` are (nnz,) int64 on A's device."""
    nnz = rows.shape[0]
    P = torch.empty(nnz, dtype=torch.float64, device=A.device)
    S = torch.empty(nnz, dtype=torch.float64, device=A.device)
    A64 = A.to(torch.float64)
    B64 = Bt.to(torch.float64)
    for s in range(0, nnz, block):
        a = A64.index_select(0, rows[s:s + block])
        b = B64.index_select(0, cols[s:s + block])
        P[s:s + block] = (a * b).sum(1)
        S[s:s + block] = (a.abs() * b.abs()).sum(1)
    return P, S


def max_rel_err(out: torch.Tensor, A: torch.Tensor, Bt: torch.Tensor,
                rows: torch.Tensor, cols: torch.Tensor) -> float:
    """The largest ``|out - P| / S`` over every nonzero (see the module
    docstring); ``inf`` where ``out`` has the wrong shape or is not
    finite."""
    if out.shape != rows.shape:
        return float("inf")
    P, S = sddmm_fp64(A, Bt, rows, cols)
    err = (out.to(torch.float64) - P).abs() / S.clamp_min(1e-300)
    worst = err.max().item() if err.numel() else 0.0
    return worst if np.isfinite(worst) else float("inf")
