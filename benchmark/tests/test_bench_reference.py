"""The plain reference against a naive loop, and the compared number."""

import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.data.generators import banded


def _naive(A, Bt, rows, cols):
    P = np.zeros(len(rows))
    S = np.zeros(len(rows))
    for i, (r, c) in enumerate(zip(rows, cols)):
        for k in range(A.shape[1]):
            P[i] += float(A[r, k]) * float(Bt[c, k])
            S[i] += abs(float(A[r, k])) * abs(float(Bt[c, k]))
    return P, S


@pytest.mark.parametrize("k,block", [(8, 7), (24, 1 << 18), (40, 64)])
def test_reference_matches_a_naive_loop(k, block):
    mask = banded(96, 900, 12, seed=k)
    gen = torch.Generator().manual_seed(k)
    A = torch.rand((96, k), generator=gen) * 2 - 1     # both signs
    Bt = torch.rand((96, k), generator=gen) * 2 - 1
    rows = torch.from_numpy(mask.coo_rows())
    cols = torch.from_numpy(mask.col_indices.astype(np.int64))
    P, S = reference.sddmm_fp64(A, Bt, rows, cols, block=block)
    want_P, want_S = _naive(A.numpy(), Bt.numpy(), mask.coo_rows(),
                            mask.col_indices)
    np.testing.assert_allclose(P.numpy(), want_P, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(S.numpy(), want_S, rtol=1e-12, atol=1e-12)


def _case():
    mask = banded(64, 500, 8, seed=3)
    gen = torch.Generator().manual_seed(3)
    A = torch.rand((64, 16), generator=gen) * 2
    Bt = torch.rand((64, 16), generator=gen) * 2
    rows = torch.from_numpy(mask.coo_rows())
    cols = torch.from_numpy(mask.col_indices.astype(np.int64))
    P, _ = reference.sddmm_fp64(A, Bt, rows, cols)
    return A, Bt, rows, cols, P


def test_max_rel_err_reads_fp32_rounding_on_a_right_answer():
    A, Bt, rows, cols, P = _case()
    err = reference.max_rel_err(P.to(torch.float32), A, Bt, rows, cols)
    assert 0 <= err < 1e-7


@pytest.mark.parametrize("fault", ["zero", "nan", "short", "scaled"])
def test_max_rel_err_reads_a_wrong_answer(fault):
    A, Bt, rows, cols, P = _case()
    out = P.to(torch.float32)
    if fault == "zero":
        out[len(out) // 2] = 0
    elif fault == "nan":
        out[0] = float("nan")
    elif fault == "short":
        out = out[:-1]
    else:
        out = out * (1 + 1e-3)
    assert reference.max_rel_err(out, A, Bt, rows, cols) >= 1e-3
