"""Sparse-attention sequence transformer on PyTorch.

The counterpart of ``bsmr_sddmm_tpu.models.sparse_transformer``: a
decoder-style transformer whose attention is restricted to a fixed causal
local + strided mask (the Sparse Transformers pattern). The mask is packed
once; every layer and head runs the hybrid SDDMM (on the card, the hand
kernels), the edge softmax and the SpMM in the tile layout, and trains
through them (``ops.graph_rphm.make_diff_sddmm_body``).
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
    """Causal attention mask: each position attends to the previous
    ``window`` positions plus every ``stride``-th earlier position (the
    Sparse Transformers "strided" pattern). Values are 1."""
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


@dataclasses.dataclass(frozen=True)
class SparseTransformer:
    """Static model description bound to one attention mask."""

    seq_len: int
    vocab_size: int
    head_dim: int
    num_heads: int = 4
    num_layers: int = 2

    @property
    def model_dim(self) -> int:
        return self.head_dim * self.num_heads


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
                 window: int = 128, stride: int = 64,
                 params: Optional[Dict] = None, device=None,
                 mesh: Optional[Mesh] = None
                 ) -> Tuple[SparseTransformerNet, Plans,
                            Union[TilePlan, List[TilePlan]]]:
    """``(net, dplan, plan)``: the transformer with its sparse attention
    bound to the packed mask plan (``local_strided_mask`` by default; the
    config defaults to ``SddmmConfig(k=head_dim, delta=0.05)``, its k set to
    ``head_dim``). ``params`` (``init_params``'s layout, default
    ``init_params(model)``) are copied onto ``device``, the CUDA device
    unless the caller names another; ``dplan`` is the full device plan.
    With a ``mesh``, as ``graph_transformer.make_forward``: the owned
    shards' device plans, every shard's plan, ``device`` the first owned
    shard's by default."""
    device = resolve_device(device if device is not None or mesh is None
                            else mesh.devices[0])
    mask = mask if mask is not None else local_strided_mask(
        model.seq_len, window=window, stride=stride)
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
