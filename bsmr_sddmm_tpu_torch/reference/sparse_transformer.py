"""Plain reference of the Sparse Transformer with the "fixed" attention
pattern (Child et al., 2019, arXiv:1904.10509), in float32.

It holds the port's ``models.sparse_transformer`` to the published
equations: it builds the mask as a dense boolean straight from the two sets
of the fixed pattern, and runs dense masked softmax attention. It imports
torch and numpy only, no module of the port, so it shares no code with
what it checks. It takes the parameters in the layout of the port's
``init_params`` (``embed``, ``pos``, ``layer_<L>`` with ``wq``, ``wk``,
``wv``, ``wo``, the two layer norms, ``mlp_in``, ``mlp_out``, and
``unembed``), and the layer that the port's net runs: pre-norm, layer norm
at eps 1e-6 with biased variance, GELU (tanh approximation), no biases in
the projections, a learned position table.

Its matrix products run in float32 with TF32 off for matmul and cuDNN
(set on entry and put back on exit), so on a card they are not rounded
to TF32.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32_matmuls():
    """TF32 off for matmul and cuDNN inside the block; the caller's
    settings are put back after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def fixed_mask_dense(seq_len: int, stride: int, c: int,
                     device=None) -> torch.Tensor:
    """(seq_len, seq_len) bool: query i attends to key j where j <= i and
    j is in A(1) = {j : floor(j / stride) = floor(i / stride)} or in
    A(2) = {j : j mod stride >= stride - c}."""
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    same_block = torch.div(j, stride, rounding_mode="floor") == \
        torch.div(i, stride, rounding_mode="floor")
    summary = j % stride >= stride - c
    return (j <= i) & (same_block | summary)


def _layer_norm(x, scale, bias, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def attention(x: torch.Tensor, lp: dict, num_heads: int, head_dim: int,
              mask: torch.Tensor) -> torch.Tensor:
    """Multi-head masked softmax attention of one layer, each head over
    ``mask`` (a dense bool (n, n)), scores scaled by 1/sqrt(head_dim)."""
    n = x.shape[0]
    q = (x @ lp["wq"]).reshape(n, num_heads, head_dim)
    k = (x @ lp["wk"]).reshape(n, num_heads, head_dim)
    v = (x @ lp["wv"]).reshape(n, num_heads, head_dim)
    heads = []
    for h in range(num_heads):      # one (n, n) score matrix at a time
        s = (q[:, h] @ k[:, h].T) / math.sqrt(head_dim)
        p = torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1)
        heads.append(p @ v[:, h])
    return torch.cat(heads, dim=1) @ lp["wo"]


def forward(params: dict, tokens: torch.Tensor, num_heads: int,
            head_dim: int, mask: torch.Tensor) -> torch.Tensor:
    """(n, vocab) next-token logits of ``tokens`` (n,) under ``mask``."""
    with fp32_matmuls():
        x = params["embed"][tokens.long()] + params["pos"][:tokens.shape[0]]
        layers = sorted((key for key in params if key.startswith("layer_")),
                        key=lambda key: int(key.split("_")[1]))
        for key in layers:
            lp = params[key]
            x = x + attention(_layer_norm(x, lp["ln1_scale"], lp["ln1_bias"]),
                              lp, num_heads, head_dim, mask)
            h = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
            x = x + F.gelu(h @ lp["mlp_in"], approximate="tanh") \
                @ lp["mlp_out"]
        return x @ params["unembed"]


def loss(params: dict, tokens: torch.Tensor, num_heads: int, head_dim: int,
         mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of one sequence."""
    logits = forward(params, tokens, num_heads, head_dim, mask)
    return F.cross_entropy(logits[:-1], tokens[1:].long())


def scores(q: torch.Tensor, k: torch.Tensor, rows, cols,
           block_rows: int = 1024) -> torch.Tensor:
    """One head's masked scores ``(q @ k.T)[rows, cols]`` (unscaled), in
    the order of ``rows``, ``cols`` (nnz,), which must be sorted by row
    (CSR order). Computed a block of ``block_rows`` query rows at a time,
    as a dense product of the block with TF32 off, so that it fits at
    12 288 positions; in float64 where ``q`` and ``k`` are, else in
    float32."""
    dtype = (torch.float64 if q.dtype == k.dtype == torch.float64
             else torch.float32)
    rows = torch.as_tensor(np.asarray(rows), device=q.device).long()
    cols = torch.as_tensor(np.asarray(cols), device=q.device).long()
    out = torch.empty(rows.shape[0], dtype=dtype, device=q.device)
    bounds = torch.searchsorted(
        rows, torch.arange(0, q.shape[0] + block_rows, block_rows,
                           device=q.device).clamp(max=q.shape[0]))
    with fp32_matmuls():
        for b, (lo, hi) in enumerate(zip(bounds[:-1].tolist(),
                                         bounds[1:].tolist())):
            if lo == hi:
                continue
            r0 = b * block_rows
            s = q[r0:r0 + block_rows].to(dtype) @ k.to(dtype).T
            out[lo:hi] = s[rows[lo:hi] - r0, cols[lo:hi]]
    return out
