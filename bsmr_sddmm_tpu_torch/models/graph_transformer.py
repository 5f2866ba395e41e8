"""Sparse-attention graph transformer on PyTorch.

The counterpart of ``bsmr_sddmm_tpu.models.graph_transformer``: multi-head
attention over a static graph mask, layer norm and MLP, trained with Adam:

    scores  = SDDMM(Q, K^T, S)          # edge logits, only where S != 0
    alpha   = edge_softmax(scores)       # per-row normalisation
    out     = SpMM(alpha, V)             # attention-weighted aggregation

all three in the plan's tile layout (``ops.graph_rphm``); on the card the
SDDMM runs the hand kernels, forward and under autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.models._common import (SparseAttentionNet,
                                                 attention_head, dense,
                                                 layer_params,
                                                 make_adam_step)
from bsmr_sddmm_tpu_torch.ops.sddmm import DevicePlan, resolve_device
from bsmr_sddmm_tpu_torch.pack import TilePlan


@dataclasses.dataclass(frozen=True)
class GraphTransformer:
    """Static model description bound to one graph mask."""

    num_nodes: int
    feature_dim: int
    head_dim: int
    num_heads: int = 4
    num_layers: int = 2
    num_classes: int = 8

    @property
    def model_dim(self) -> int:
        return self.head_dim * self.num_heads


def init_params(model: GraphTransformer, seed: int = 0) -> Dict:
    """The JAX package's parameters for ``seed``: the same numbers, drawn in
    the same order, as a nested dict of CPU tensors."""
    rng = np.random.default_rng(seed)
    d = model.model_dim
    params = {"embed": dense(rng, (model.feature_dim, d))}
    for L in range(model.num_layers):
        params[f"layer_{L}"] = layer_params(rng, d)
    params["head"] = dense(rng, (d, model.num_classes))
    return params


class GraphTransformerNet(SparseAttentionNet):
    """``net(X (num_nodes, feature_dim), dplan) -> (num_nodes,
    num_classes)`` logits."""

    def forward(self, X: torch.Tensor, dplan: DevicePlan) -> torch.Tensor:
        return self.layers(X @ self.embed, dplan) @ self.head


def make_forward(model: GraphTransformer, csr: CSR,
                 config: Optional[SddmmConfig] = None,
                 params: Optional[Dict] = None, device=None
                 ) -> Tuple[GraphTransformerNet, DevicePlan, TilePlan]:
    """``(net, dplan, plan)``: the graph transformer with its attention
    bound to ``csr``'s packed plan (config default ``SddmmConfig(k=
    head_dim)``, its k set to ``head_dim``). ``params`` (``init_params``'s
    layout, default ``init_params(model)``) are copied onto ``device``, the
    CUDA device unless the caller names another; ``dplan`` is the full
    device plan."""
    device = resolve_device(device)
    config = config or SddmmConfig(k=model.head_dim)
    head_fn, dplan, plan = attention_head(csr, config, model.head_dim,
                                          device)
    net = GraphTransformerNet(
        init_params(model) if params is None else params, head_fn,
        model.num_heads, model.head_dim, model.num_layers, device)
    return net, dplan, plan


def loss_fn(net: GraphTransformerNet, X: torch.Tensor, labels: torch.Tensor,
            dplan: DevicePlan) -> torch.Tensor:
    """Mean cross-entropy over the nodes."""
    logp = F.log_softmax(net(X, dplan), dim=-1)
    return -logp.gather(1, labels[:, None].long()).mean()


def make_train_step(model: GraphTransformer, net: GraphTransformerNet,
                    learning_rate: float = 1e-3
                    ) -> Tuple[Callable, Callable]:
    """``(opt_init, train_step)``: ``opt = opt_init()`` (Adam, as
    optax.adam), ``train_step(opt, X, labels, dplan) -> loss`` updates
    ``net`` in place."""
    return make_adam_step(net, loss_fn, learning_rate)
