"""Sparse-attention sequence transformer on PyTorch.

The counterpart of ``bsmr_sddmm_tpu.models.sparse_transformer``: a
decoder-style transformer whose attention is restricted to one fixed
causal mask, the JAX package's local + summary-column mask
(:func:`local_strided_mask`) or the Sparse Transformer's "fixed" pattern
(:func:`fixed_mask`). The mask is packed once; every layer and head runs
the hybrid SDDMM (on the card, the hand kernels), the edge softmax and the
SpMM in the tile layout, and trains through them
(``ops.graph_rphm.make_diff_sddmm_body``). :data:`ENWIK8` is the paper's
enwik8 model.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import COO, CSR
from bsmr_sddmm_tpu_torch.models._common import (Plans, SparseAttentionNet,
                                                 attention_head, dense,
                                                 layer_params,
                                                 make_adam_step)
from bsmr_sddmm_tpu_torch.ops.sddmm import resolve_device
from bsmr_sddmm_tpu_torch.pack import TilePlan
from bsmr_sddmm_tpu_torch.parallel.sharding import Mesh


def local_strided_mask(seq_len: int, window: int = 128,
                       stride: int = 64) -> CSR:
    """Causal attention mask: a sliding window, each position attending to
    itself and the ``window - 1`` positions before it, plus the summary
    column ``stride * j - 1`` of each stride ``j = 1, 2, ...`` that lies
    before the window. Values are 1. It is neither of the Sparse
    Transformer's patterns: the paper's "strided" pattern takes the columns
    ``j`` with ``(i - j) mod stride = 0`` and its "fixed" pattern is
    :func:`fixed_mask`."""
    rows_parts, cols_parts = [], []
    q = np.arange(seq_len, dtype=np.int64)
    # local band (causal)
    for off in range(window):
        keep = q - off >= 0
        rows_parts.append(q[keep])
        cols_parts.append(q[keep] - off)
    # strided summaries
    n_glob = seq_len // stride
    if n_glob:
        g = (np.arange(n_glob, dtype=np.int64) + 1) * stride - 1
        for gc in g:
            keep = q > gc + window - 1  # beyond the local band
            rows_parts.append(q[keep])
            cols_parts.append(np.full(int(keep.sum()), gc, np.int64))
    rows = np.concatenate(rows_parts)
    cols = np.concatenate(cols_parts)
    keys = rows * np.int64(seq_len) + cols
    uniq = np.unique(keys)
    ri = (uniq // seq_len).astype(np.int32)
    ci = (uniq % seq_len).astype(np.int32)
    return COO(seq_len, seq_len, ri, ci,
               np.ones(uniq.shape[0], np.float32)).to_csr()


def fixed_mask(seq_len: int, stride: int = 128, c: int = 32) -> CSR:
    """The Sparse Transformer's "fixed" attention pattern (Child et al.,
    2019, arXiv:1904.10509), its two heads merged into one head over their
    union: query ``i`` attends to the causal ``j <= i`` in

    - A(1) = {j : floor(j / stride) = floor(i / stride)}, its own block;
    - A(2) = {j : j mod stride >= stride - c}, the last ``c`` "summary"
      positions of every block.

    Values are 1. A row holds the summaries of the blocks before its own,
    then its own block up to itself, so it is built in CSR order block by
    block, with no sort: row ``i`` of block ``b`` at position ``p`` holds
    ``b * c + p + 1`` nonzeros."""
    if not 1 <= c <= stride:
        raise ValueError(f"need 1 <= c <= stride, got c={c}, "
                         f"stride={stride}")
    summaries = (np.arange(stride - c, stride, dtype=np.int64)[None, :]
                 + stride * np.arange(-(-seq_len // stride),
                                      dtype=np.int64)[:, None]).reshape(-1)
    row_nnz = np.empty(seq_len, np.int64)
    cols = []
    for b, start in enumerate(range(0, seq_len, stride)):
        n = min(stride, seq_len - start)
        pos = np.arange(n, dtype=np.int64)
        row_nnz[start:start + n] = b * c + pos + 1
        # each row's summaries, then the block's columns up to the row
        full = np.concatenate([np.broadcast_to(summaries[:b * c], (n, b * c)),
                               np.broadcast_to(start + pos, (n, n))], axis=1)
        keep = np.concatenate([np.ones((n, b * c), bool),
                               pos[None, :] <= pos[:, None]], axis=1)
        cols.append(full[keep])
    row_offsets = np.zeros(seq_len + 1, np.int64)
    np.cumsum(row_nnz, out=row_offsets[1:])
    col_indices = np.concatenate(cols).astype(np.int32)
    return CSR(seq_len, seq_len, row_offsets, col_indices,
               np.ones(col_indices.shape[0], np.float32))


@dataclasses.dataclass(frozen=True)
class SparseTransformer:
    """Static model description bound to one attention mask.

    ``pattern`` names the mask :func:`make_forward` builds:
    ``"local_strided"`` (:func:`local_strided_mask`, its window and stride
    given to ``make_forward``; ``stride`` and ``c`` stay unset) or
    ``"fixed"`` (:func:`fixed_mask` at this model's ``stride`` and ``c``,
    both required)."""

    seq_len: int
    vocab_size: int
    head_dim: int
    num_heads: int = 4
    num_layers: int = 2
    pattern: str = "local_strided"
    stride: Optional[int] = None
    c: Optional[int] = None

    def __post_init__(self):
        if self.pattern not in ("local_strided", "fixed"):
            raise ValueError(f"unknown attention pattern {self.pattern!r}")
        if self.pattern == "fixed" and None in (self.stride, self.c):
            raise ValueError("pattern 'fixed' needs stride and c")
        if self.pattern == "local_strided" and (self.stride,
                                                self.c) != (None, None):
            raise ValueError("pattern 'local_strided' takes its window and "
                             "stride from make_forward; leave stride and c "
                             "unset")

    @property
    def model_dim(self) -> int:
        return self.head_dim * self.num_heads


#: The Sparse Transformer's enwik8 model (Child et al., 2019,
#: arXiv:1904.10509): 30 layers, 8 heads, d = 512 (head dimension 64),
#: 12 288 positions, a byte vocabulary of 256, the "fixed" attention pattern
#: at stride 128 and c = 32, its heads merged into one head over the union
#: of the two sets. The port's layer departs from the paper: a pre-norm
#: layer with GELU (tanh approximation) and no biases in its projections,
#: no dropout, a learned position table in place of the paper's position
#: embeddings, and the paper's weight-init scaling (by 1/sqrt(2N)) left
#: out: ``init_params`` draws as the JAX package does.
ENWIK8 = SparseTransformer(seq_len=12288, vocab_size=256, head_dim=64,
                           num_heads=8, num_layers=30, pattern="fixed",
                           stride=128, c=32)


def init_params(model: SparseTransformer, seed: int = 0) -> Dict:
    """The JAX package's parameters for ``seed``: the same numbers, drawn in
    the same order, as a nested dict of CPU tensors."""
    rng = np.random.default_rng(seed)
    d = model.model_dim
    params = {
        "embed": dense(rng, (model.vocab_size, d), scale=0.02),
        "pos": dense(rng, (model.seq_len, d), scale=0.02),
    }
    for L in range(model.num_layers):
        params[f"layer_{L}"] = layer_params(rng, d)
    params["unembed"] = dense(rng, (d, model.vocab_size))
    return params


class SparseTransformerNet(SparseAttentionNet):
    """``net(tokens (seq_len,), dplan) -> (seq_len, vocab)`` next-token
    logits; ``dplan`` is the list of the owned shards' device plans on a
    net built over a mesh."""

    def forward(self, tokens: torch.Tensor, dplan: Plans) -> torch.Tensor:
        x = self.embed.index_select(0, tokens) + self.pos
        return self.layers(x, dplan) @ self.unembed


def make_forward(model: SparseTransformer, mask: Optional[CSR] = None,
                 config: Optional[SddmmConfig] = None,
                 window: Optional[int] = None,
                 stride: Optional[int] = None,
                 params: Optional[Dict] = None, device=None,
                 mesh: Optional[Mesh] = None
                 ) -> Tuple[SparseTransformerNet, Plans,
                            Union[TilePlan, List[TilePlan]]]:
    """``(net, dplan, plan)``: the transformer with its sparse attention
    bound to the packed mask plan (the model's own by default:
    :func:`fixed_mask` at its stride and c for ``pattern="fixed"``, else
    :func:`local_strided_mask` at ``window`` and ``stride``, 128 and 64
    unless given, which a fixed-pattern model refuses; the
    config defaults to ``SddmmConfig(k=head_dim, delta=0.05)``, its k set to
    ``head_dim``). ``params`` (``init_params``'s layout, default
    ``init_params(model)``) are copied onto ``device``, the CUDA device
    unless the caller names another; ``dplan`` is the full device plan.
    With a ``mesh``, as ``graph_transformer.make_forward``: the owned
    shards' device plans, every shard's plan, ``device`` the first owned
    shard's by default."""
    device = resolve_device(device if device is not None or mesh is None
                            else mesh.devices[0])
    if model.pattern == "fixed" and (window, stride) != (None, None):
        raise ValueError("a fixed-pattern model takes its stride and c "
                         "from its fields, not window or stride")
    if mask is None:
        mask = (fixed_mask(model.seq_len, model.stride, model.c)
                if model.pattern == "fixed" else
                local_strided_mask(model.seq_len,
                                   window=128 if window is None else window,
                                   stride=64 if stride is None else stride))
    config = config or SddmmConfig(k=model.head_dim, delta=0.05)
    head_fn, dplan, plan = attention_head(mask, config, model.head_dim,
                                          device, mesh)
    net = SparseTransformerNet(
        init_params(model) if params is None else params, head_fn,
        model.num_heads, model.head_dim, model.num_layers, device, mesh)
    return net, dplan, plan


def loss_fn(net: SparseTransformerNet, tokens: torch.Tensor,
            dplan: Plans) -> torch.Tensor:
    """Mean next-token cross-entropy of one sequence."""
    logp = F.log_softmax(net(tokens, dplan)[:-1], dim=-1)
    return -logp.gather(1, tokens[1:, None].long()).mean()


def make_train_step(model: SparseTransformer, net: SparseTransformerNet,
                    learning_rate: float = 1e-3
                    ) -> Tuple[Callable, Callable]:
    """``(opt_init, train_step)``: ``opt = opt_init()`` (Adam, as
    optax.adam), ``train_step(opt, tokens, dplan) -> loss`` updates
    ``net`` in place (``dplan`` a list on a net built over a mesh)."""
    return make_adam_step(net, loss_fn, learning_rate)
