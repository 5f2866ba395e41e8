"""What the two model families share: parameters drawn and laid out as the
JAX package's (``x @ W`` with W (d_in, d_out), under the names of its
params pytree), its layer norm, and the pre-norm transformer layers over a
sparse attention head, on one device or over the row-panel shards of a
mesh.

Over a mesh (``parallel.sharding.Mesh``) the net is data parallel as the
JAX package's train step is under ``bsmr_sddmm_tpu.parallel.sharding.
shard_device_plan``: parameters, features and tokens replicated, and each
shard runs the tile-layout attention (SDDMM, edge softmax, SpMM) on its
own rows. The shards execute on the per-shard packed plans of
``pack.pack_shard_plans``, not on ``shard_device_plan``'s even split (a
GSPMD annotation that cuts rows across shards): a shard owns whole rows,
so the edge softmax's row max and row sum stay shard-local, and the
SpMM's output rows of different shards are disjoint (a row a shard does
not own comes back exactly 0 from it and sends no gradient to ``q``). The
head outputs are summed over the shards (``collectives.from_shards``), q,
k and v handed to them by ``collectives.to_shards``, the two ends autograd
sees; the layers, layer norm and MLP stay replicated."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.ops.graph_rphm import make_sparse_attention_rphm
from bsmr_sddmm_tpu_torch.ops.sddmm import (DevicePlan, device_plan,
                                            make_sddmm_body)
from bsmr_sddmm_tpu_torch.pack import pack_shard_plans, pack_tiles
from bsmr_sddmm_tpu_torch.parallel import collectives
from bsmr_sddmm_tpu_torch.parallel.sharding import Mesh
from bsmr_sddmm_tpu_torch.reorder import bsmr

#: one device plan, or the owned shards' device plans over a mesh
Plans = Union[DevicePlan, List[DevicePlan]]


def dense(rng: np.random.Generator, shape, scale: Optional[float] = None
          ) -> torch.Tensor:
    """The JAX package's weight draw: normal(0, scale), scale 1/sqrt(d_in)
    by default, drawn in float64 and rounded to float32."""
    scale = scale or (1.0 / np.sqrt(shape[0]))
    return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))


def layer_params(rng: np.random.Generator, d: int) -> Dict[str, torch.Tensor]:
    """One layer's parameters, drawn in the JAX package's order."""
    return {
        "wq": dense(rng, (d, d)), "wk": dense(rng, (d, d)),
        "wv": dense(rng, (d, d)), "wo": dense(rng, (d, d)),
        "ln1_scale": torch.ones(d), "ln1_bias": torch.zeros(d),
        "ln2_scale": torch.ones(d), "ln2_bias": torch.zeros(d),
        "mlp_in": dense(rng, (d, 4 * d)), "mlp_out": dense(rng, (4 * d, d)),
    }


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """The JAX package's layer norm: eps 1e-6, biased variance."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def attention_head(mask: CSR, config: SddmmConfig, k: int, device,
                   mesh: Optional[Mesh] = None) -> tuple:
    """Reorder and pack ``mask`` and build the tile-layout attention head
    over it: ``(head_fn, full device plan, plan)`` on ``device``.

    With a ``mesh``: reorder once, pack one plan per shard
    (``pack_shard_plans``) and return ``([head_fn], [full device plan],
    plans)``, the lists over this process's shards, each plan on its
    shard's device, ``plans`` over every shard. One SDDMM body, built from
    ``plans[0]``, serves every shard (the packer pads the shards to common
    shapes); each head keeps its own plan's constants (column map, row
    positions)."""
    config = config.replace(k=k)
    reord = bsmr(mask, config)
    if mesh is None:
        plan = pack_tiles(mask, reord, config, k=k)
        body = make_sddmm_body(plan, config, emit="rphm")
        return (make_sparse_attention_rphm(plan, body),
                device_plan(plan, device), plan)
    plans = pack_shard_plans(mask, reord, config, mesh.size, k=k)
    body = make_sddmm_body(plans[0], config, emit="rphm")
    return ([make_sparse_attention_rphm(plans[s], body) for s in mesh.owned],
            [device_plan(plans[s], dev)
             for s, dev in zip(mesh.owned, mesh.devices)], plans)


class SparseAttentionNet(nn.Module):
    """Pre-norm transformer layers whose attention is one sparse head per
    head slice, looped as the JAX package loops them. The parameters are
    registered under the names of the JAX params pytree (``embed``,
    ``layer_0.wq``, ...) and keep its layout. ``head_fn`` is one head
    callable, or with a ``mesh`` the list of the owned shards' heads, and
    the net then takes the list of their device plans where it takes one
    device plan."""

    def __init__(self, params: Dict, head_fn: Union[Callable, List],
                 num_heads: int, head_dim: int, num_layers: int, device,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        self.head_fn, self.mesh = head_fn, mesh
        self.num_heads, self.head_dim = num_heads, head_dim
        self.num_layers = num_layers
        for name, value in params.items():
            if isinstance(value, dict):
                self.add_module(name, nn.ParameterDict({
                    key: nn.Parameter(torch.as_tensor(v).to(device).clone())
                    for key, v in value.items()}))
            else:
                self.register_parameter(name, nn.Parameter(
                    torch.as_tensor(value).to(device).clone()))

    def attention(self, lp: nn.ParameterDict, x: torch.Tensor,
                  dplan) -> torch.Tensor:
        n, h, hd = x.shape[0], self.num_heads, self.head_dim
        q = (x @ lp["wq"]).reshape(n, h, hd)
        kk = (x @ lp["wk"]).reshape(n, h, hd)
        v = (x @ lp["wv"]).reshape(n, h, hd)
        if self.mesh is None:
            heads = torch.stack([self.head_fn(q[:, i], kk[:, i], v[:, i],
                                              dplan) for i in range(h)], dim=1)
        else:
            # q, k, v to every shard, each shard's heads over its own rows,
            # and their sum back: one collective of each kind a layer
            parts = [torch.stack([fn(qkv[0][:, i], qkv[1][:, i],
                                     qkv[2][:, i], dp) for i in range(h)],
                                 dim=1)
                     for fn, qkv, dp in zip(
                         self.head_fn, collectives.to_shards(
                             torch.stack([q, kk, v]), self.mesh), dplan)]
            heads = collectives.from_shards(parts, self.mesh, x.device)
        return heads.reshape(n, h * hd) @ lp["wo"]

    def layers(self, x: torch.Tensor, dplan) -> torch.Tensor:
        for L in range(self.num_layers):
            lp = getattr(self, f"layer_{L}")
            x = x + self.attention(
                lp, layer_norm(x, lp["ln1_scale"], lp["ln1_bias"]), dplan)
            hmid = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
            # jax.nn.gelu defaults to the tanh approximation
            x = x + F.gelu(hmid @ lp["mlp_in"],
                           approximate="tanh") @ lp["mlp_out"]
        return x


def make_adam_step(net: nn.Module, loss_fn: Callable,
                   learning_rate: float) -> tuple:
    """``(opt_init, train_step)``: ``opt_init()`` is ``torch.optim.Adam``
    over ``net``'s parameters at ``learning_rate`` with optax.adam's
    defaults (0.9, 0.999, 1e-8); ``train_step(opt, *batch)`` takes one
    step on ``loss_fn(net, *batch)`` and returns that loss."""
    def opt_init() -> torch.optim.Adam:
        return torch.optim.Adam(net.parameters(), lr=learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)

    def train_step(opt: torch.optim.Adam, *batch) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(net, *batch)
        loss.backward()
        opt.step()
        return loss.detach()

    return opt_init, train_step

