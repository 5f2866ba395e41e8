"""What the two model families share: parameters drawn and laid out as the
JAX package's (``x @ W`` with W (d_in, d_out), under the names of its
params pytree), its layer norm, and the pre-norm transformer layers over a
sparse attention head."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.ops.graph_rphm import make_sparse_attention_rphm
from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan, make_sddmm_body
from bsmr_sddmm_tpu_torch.pack import pack_tiles
from bsmr_sddmm_tpu_torch.reorder import bsmr


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


def attention_head(mask: CSR, config: SddmmConfig, k: int, device
                   ) -> tuple:
    """Reorder and pack ``mask`` and build the tile-layout attention head
    over it: ``(head_fn, full device plan, plan)``."""
    config = config.replace(k=k)
    plan = pack_tiles(mask, bsmr(mask, config), config, k=k)
    body = make_sddmm_body(plan, config, emit="rphm")
    return (make_sparse_attention_rphm(plan, body),
            device_plan(plan, device), plan)


class SparseAttentionNet(nn.Module):
    """Pre-norm transformer layers whose attention is one sparse head per
    head slice, looped as the JAX package loops them. The parameters are
    registered under the names of the JAX params pytree (``embed``,
    ``layer_0.wq``, ...) and keep its layout."""

    def __init__(self, params: Dict, head_fn: Callable, num_heads: int,
                 head_dim: int, num_layers: int, device):
        super().__init__()
        self.head_fn = head_fn
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
        heads = torch.stack([self.head_fn(q[:, i], kk[:, i], v[:, i], dplan)
                             for i in range(h)], dim=1)
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

