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
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.models._common import (Plans, SparseAttentionNet,
                                                 attention_head, dense,
                                                 layer_params,
                                                 make_adam_step)
from bsmr_sddmm_tpu_torch.ops.sddmm import resolve_device
from bsmr_sddmm_tpu_torch.pack import TilePlan
from bsmr_sddmm_tpu_torch.parallel.sharding import Mesh


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
    num_classes)`` logits; ``dplan`` is the list of the owned shards'
    device plans on a net built over a mesh."""

    def forward(self, X: torch.Tensor, dplan: Plans) -> torch.Tensor:
        return self.layers(X @ self.embed, dplan) @ self.head


def make_forward(model: GraphTransformer, csr: CSR,
                 config: Optional[SddmmConfig] = None,
                 params: Optional[Dict] = None, device=None,
                 mesh: Optional[Mesh] = None
                 ) -> Tuple[GraphTransformerNet, Plans,
                            Union[TilePlan, List[TilePlan]]]:
    """``(net, dplan, plan)``: the graph transformer with its attention
    bound to ``csr``'s packed plan (config default ``SddmmConfig(k=
    head_dim)``, its k set to ``head_dim``). ``params`` (``init_params``'s
    layout, default ``init_params(model)``) are copied onto ``device``, the
    CUDA device unless the caller names another; ``dplan`` is the full
    device plan.

    With a ``mesh`` (``parallel.make_mesh``) the attention runs over its
    row-panel shards (``models._common``): ``dplan`` is the list of the
    owned shards' full device plans, ``plan`` the list of every shard's
    plan, and ``device`` defaults to the first owned shard's. The step
    equals the JAX package's ``make_train_step`` on
    ``bsmr_sddmm_tpu.parallel.sharding.shard_device_plan``'s plan."""
    device = resolve_device(device if device is not None or mesh is None
                            else mesh.devices[0])
    config = config or SddmmConfig(k=model.head_dim)
    head_fn, dplan, plan = attention_head(csr, config, model.head_dim,
                                          device, mesh)
    net = GraphTransformerNet(
        init_params(model) if params is None else params, head_fn,
        model.num_heads, model.head_dim, model.num_layers, device, mesh)
    return net, dplan, plan


def loss_fn(net: GraphTransformerNet, X: torch.Tensor, labels: torch.Tensor,
            dplan: Plans) -> torch.Tensor:
    """Mean cross-entropy over the nodes."""
    logp = F.log_softmax(net(X, dplan), dim=-1)
    return -logp.gather(1, labels[:, None].long()).mean()


def make_train_step(model: GraphTransformer, net: GraphTransformerNet,
                    learning_rate: float = 1e-3
                    ) -> Tuple[Callable, Callable]:
    """``(opt_init, train_step)``: ``opt = opt_init()`` (Adam, as
    optax.adam), ``train_step(opt, X, labels, dplan) -> loss`` updates
    ``net`` in place (``dplan`` a list on a net built over a mesh)."""
    return make_adam_step(net, loss_fn, learning_rate)
