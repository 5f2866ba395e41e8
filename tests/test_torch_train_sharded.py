"""The port's train step over a mesh against the JAX package's.

The JAX package trains over a mesh by handing its jitted
``make_train_step`` the plan that ``parallel.shard_device_plan`` shards
over ``parallel.make_mesh(n)`` (GSPMD partitions the step; the 8 virtual
CPU devices of tests/conftest.py). The port runs the same step over the
per-shard packed plans of a CPU mesh (``make_forward(..., mesh=
make_mesh(devices=["cpu"] * n))``): both families at n = 2 and 4, a plan
whose four tiers all hold nonzeros, a windowed plan, and n = 8 on a mask
where one shard is pure padding and three hold no residual.

Both sides start from the same weights (``params_from_reference``) and
inputs (NumPy, fixed seeds). One jitted JAX step gives the loss, the
gradients (Adam's first moment after one step is (1 - b1) * g, so g is
read back from the optimiser state to about one fp32 ulp) and, after a
second step, the parameters. Tolerances: loss rtol 1e-5; every gradient
rtol 1e-3 / atol 1e-5; parameters after 2 Adam steps (lr 1e-3) rtol 1e-4
/ atol 1e-6. The port's sharded step is also held to its own unsharded
step: loss rtol 1e-5, gradients rtol 1e-5 / atol 1e-5 x that tensor's
largest |g| (two packings of one mask: only the order of summation
differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import _torch_threads  # noqa: F401  (this worker's thread budget)

import bsmr_sddmm_tpu.parallel as jpar
from bsmr_sddmm_tpu.config import SddmmConfig as JConfig
from bsmr_sddmm_tpu.formats import random_mask as j_random_mask
from bsmr_sddmm_tpu.models import graph_transformer as j_gt
from bsmr_sddmm_tpu.models import sparse_transformer as j_st

from bsmr_sddmm_tpu_torch.formats import random_mask
from bsmr_sddmm_tpu_torch.interop import (config_from_reference,
                                          params_from_reference)
from bsmr_sddmm_tpu_torch.models import graph_transformer as gt
from bsmr_sddmm_tpu_torch.models import sparse_transformer as st
from bsmr_sddmm_tpu_torch.models._common import layer_norm
from bsmr_sddmm_tpu_torch.parallel import collectives, make_mesh

BASE = dict(panel_height=16, dense_chunk=16, residual_chunk=2048)
# (family, model, mask, config): every case's plan, unsharded and per shard
CASES = {
    # dense (G=2), packed, gathered and residual tiers all hold nonzeros
    "tiers": ("graph", dict(num_nodes=384, feature_dim=16, head_dim=16,
                            num_heads=2, num_layers=2, num_classes=8),
              dict(rows=384, cols=384, nnz=6000, seed=5, block_rows=16,
                   block_cols=64),
              dict(BASE, k=16, delta=0.05, residual_tile_min_nnz=32)),
    # tests/test_torch_models.py's SEQ_TRAIN: dense and packed tiles
    "sparse": ("sparse", dict(seq_len=128, vocab_size=32, head_dim=16,
                              num_heads=2, num_layers=1),
               dict(window=16, stride=32),
               dict(BASE, k=16, residual_chunk=1024, delta=0.05)),
    # B-side gather windows of 8192 rows on a 32768-node graph
    "windowed": ("graph", dict(num_nodes=32768, feature_dim=16, head_dim=32,
                               num_heads=1, num_layers=1, num_classes=8),
                 dict(rows=32768, cols=32768, nnz=40000, seed=29,
                      block_rows=16, block_cols=64),
                 dict(BASE, k=32, gather_window_mb=1,
                      gather_window_threshold_mb=1, residual_tile_min_nnz=4)),
    # at n=8 shard 6 is pure padding (its rows read row 0, which shard 1
    # owns) and shards 2, 6 and 7 hold no residual
    "padding": ("graph", dict(num_nodes=256, feature_dim=16, head_dim=16,
                              num_heads=2, num_layers=1, num_classes=8),
                dict(rows=256, cols=256, nnz=6000, seed=5, block_rows=16,
                     block_cols=64),
                dict(BASE, k=16)),
}
RUNS = [("tiers", 2), ("tiers", 4), ("sparse", 2), ("sparse", 4),
        ("windowed", 2), ("padding", 8)]
LR, B1 = 1e-3, 0.9


class Case:
    """One case built on both packages: the JAX forward and plan, its
    jitted ``make_train_step``, the port's model, mask, config, weights and
    batch."""

    def __init__(self, name):
        kind, model_kw, mask_kw, cfg_kw = CASES[name]
        self.kind = kind
        jcfg = JConfig(**cfg_kw)
        self.cfg = config_from_reference(jcfg)
        jm = j_st if kind == "sparse" else j_gt
        self.port = st if kind == "sparse" else gt
        if kind == "sparse":
            self.jmodel = j_st.SparseTransformer(**model_kw)
            self.model = st.SparseTransformer(**model_kw)
            self.mask = st.local_strided_mask(self.model.seq_len, **mask_kw)
            jfwd, _, self.jplan = j_st.make_forward(
                self.jmodel, mask=j_st.local_strided_mask(
                    self.model.seq_len, **mask_kw), config=jcfg)
            rng = np.random.default_rng(1)
            self.batch = (rng.integers(0, self.model.vocab_size,
                                       self.model.seq_len).astype(np.int32),)
        else:
            self.jmodel = j_gt.GraphTransformer(**model_kw)
            self.model = gt.GraphTransformer(**model_kw)
            self.mask = random_mask(**mask_kw)
            jfwd, _, self.jplan = j_gt.make_forward(
                self.jmodel, j_random_mask(**mask_kw), config=jcfg)
            rng = np.random.default_rng(2)
            self.batch = (
                rng.normal(size=(self.model.num_nodes,
                                 self.model.feature_dim)).astype(np.float32),
                rng.integers(0, self.model.num_classes,
                             self.model.num_nodes).astype(np.int32))
        self.jparams = jm.init_params(self.jmodel)
        self.j_init, step = jm.make_train_step(self.jmodel, jfwd, LR)
        self.j_step = jax.jit(step)

    def jax_run(self, n):
        """The JAX step on ``shard_device_plan`` over an n-device mesh, its
        inputs replicated: (loss, gradients, parameters after 2 steps),
        flattened."""
        mesh = jpar.make_mesh(n)
        dplan = jpar.shard_device_plan(self.jplan, mesh)
        repl = NamedSharding(mesh, PartitionSpec())
        params = jax.device_put(self.jparams, repl)
        state = jax.device_put(self.j_init(self.jparams), repl)
        batch = tuple(jax.device_put(jnp.asarray(x), repl)
                      for x in self.batch)
        params, state, loss = self.j_step(params, state, *batch, dplan)
        grads = {k: v / (1 - B1) for k, v in flat(state[0].mu).items()}
        params, _, _ = self.j_step(params, state, *batch, dplan)
        return float(loss), grads, flat(params)

    def tbatch(self):
        return tuple(torch.from_numpy(x.copy()) for x in self.batch)

    def net(self, mesh=None):
        kw = dict(config=self.cfg, params=params_from_reference(self.jparams))
        if mesh is None:
            kw["device"] = "cpu"
        else:
            kw["mesh"] = mesh
        if self.kind == "sparse":
            return st.make_forward(self.model, mask=self.mask, **kw)
        return gt.make_forward(self.model, self.mask, **kw)

    def loss_and_grads(self, net, dplan):
        loss = self.port.loss_fn(net, *self.tbatch(), dplan)
        loss.backward()
        return float(loss.detach()), {name: p.grad.numpy().copy()
                                      for name, p in net.named_parameters()}


def flat(tree, prefix=""):
    """A nested dict of arrays as {"a.b": array}."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def cases():
    """Each case built once per module (the JAX step compiles once per
    case and mesh size)."""
    built = {}

    def get(name):
        if name not in built:
            built[name] = Case(name)
        return built[name]
    return get


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def assert_all_close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


@pytest.mark.parametrize("name,n", RUNS)
def test_sharded_step_matches_reference(cases, name, n):
    """Loss, every gradient and the parameters after two Adam steps of the
    port's n-shard step against the JAX package's step on
    shard_device_plan."""
    case = cases(name)
    jloss, jgrads, jparams2 = case.jax_run(n)
    net, dplan, plans = case.net(cpu_mesh(n))
    assert isinstance(dplan, list) and len(dplan) == n == len(plans)
    loss, grads = case.loss_and_grads(net, dplan)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert_all_close(grads, jgrads, rtol=1e-3, atol=1e-5)
    opt_init, step = case.port.make_train_step(case.model, net, LR)
    opt = opt_init()
    for _ in range(2):
        step(opt, *case.tbatch(), dplan)
    assert_all_close({name: p.detach().numpy()
                  for name, p in net.named_parameters()}, jparams2,
                 rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name,n", RUNS)
def test_sharded_step_matches_unsharded(cases, name, n):
    """The port's n-shard step equals its single-device step: the loss,
    every gradient, and one collective of each kind a layer."""
    case = cases(name)
    net, dplan, plan = case.net()
    loss, grads = case.loss_and_grads(net, dplan)
    snet, sdplan, _ = case.net(cpu_mesh(n))
    collectives.zero_counts()
    sloss, sgrads = case.loss_and_grads(snet, sdplan)
    counts = collectives.read_counts()
    layers = case.model.num_layers
    assert (counts["to_shards"], counts["from_shards"]) == (layers, layers)
    assert counts["all_reduce"] == counts["cross_process_bytes"] == 0
    np.testing.assert_allclose(sloss, loss, rtol=1e-5)
    for name, g in grads.items():
        np.testing.assert_allclose(sgrads[name], g, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(g).max()),
                                   err_msg=name)


def test_plans_cover_the_edge_cases():
    """The cases hold what they stand for: all four tiers, gather windows,
    a pure-padding shard and shards with no residual."""
    from bsmr_sddmm_tpu_torch.pack import pack_shard_plans, pack_tiles
    from bsmr_sddmm_tpu_torch.reorder import bsmr

    def plans(name, n):
        _, _, mask_kw, cfg_kw = CASES[name]
        csr = random_mask(**mask_kw)
        cfg = config_from_reference(JConfig(**cfg_kw))
        reord = bsmr(csr, cfg)
        return (pack_tiles(csr, reord, cfg, k=cfg.k),
                pack_shard_plans(csr, reord, cfg, n, k=cfg.k))

    plan, _ = plans("tiers", 2)
    assert plan.fat_group > 1
    assert min(plan.num_tiles, plan.num_packed, plan.num_gathered,
               plan.residual_nnz) > 0
    plan, shards = plans("windowed", 2)
    assert plan.window_rows and all(p.window_rows for p in shards)
    _, shards = plans("padding", 8)
    real = [[int((getattr(p, m) < p.nnz).sum()) for m in
             ("tile_scatter", "sp_scatter", "g_scatter", "res_out")]
            for p in shards]
    assert real[6] == [0, 0, 0, 0]
    assert not shards[6].row_perm_padded.any()
    assert [s for s, r in enumerate(real) if not r[3]] == [2, 6, 7]


def test_a_shard_adds_nothing_to_rows_it_does_not_own(cases):
    """On the padding case at n=8, each shard's head output and its
    gradient to q are exactly 0 on every row the shard holds no nonzero of
    (row 0 included, which the pure-padding shard's rows repeat), and the
    shards' outputs sum to the single-device head's."""
    case = cases("padding")
    snet, sdplan, plans = case.net(cpu_mesh(8))
    net, dplan, _ = case.net()
    X = case.tbatch()[0]
    lp = net.layer_0
    with torch.no_grad():
        xn = layer_norm(X @ net.embed, lp["ln1_scale"], lp["ln1_bias"])
        n, hd = xn.shape[0], case.model.head_dim
        q, kk, v = ((xn @ lp[w]).reshape(n, -1, hd)[:, 0]
                    for w in ("wq", "wk", "wv"))
    want = net.head_fn(q, kk, v, dplan)
    rows = case.mask.coo_rows()
    w = torch.from_numpy(np.random.default_rng(4).normal(
        size=tuple(want.shape)).astype(np.float32))
    total = torch.zeros_like(want)
    for fn, dp, p in zip(snet.head_fn, sdplan, plans):
        qs = q.clone().requires_grad_()
        out = fn(qs, kk, v, dp)
        (out * w).sum().backward()
        scatter = np.concatenate([getattr(p, m).reshape(-1) for m in (
            "tile_scatter", "sp_scatter", "g_scatter", "res_out")])
        owned = np.zeros(n, bool)
        owned[rows[scatter[scatter < p.nnz]]] = True
        assert not out[~owned].any() and not qs.grad[~owned].any()
        total += out.detach()
    assert not owned[0] and plans[6].row_perm_padded[0] == 0
    np.testing.assert_allclose(total.numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-6)


def test_make_forward_over_a_mesh_takes_the_card_unless_told(monkeypatch):
    """With a mesh the net lives on the first owned shard's device; with no
    card and no devices named, make_mesh raises rather than fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    model = gt.GraphTransformer(**CASES["padding"][1])
    mesh = cpu_mesh(2)
    net, dplan, plans = gt.make_forward(
        model, random_mask(**CASES["padding"][2]),
        config=config_from_reference(JConfig(**CASES["padding"][3])),
        mesh=mesh)
    assert net.embed.device == torch.device("cpu") and net.mesh is mesh
    assert [d.row_perm_padded.device.type for d in dplan] == ["cpu", "cpu"]
    assert len(plans) == 2 and len(net.head_fn) == 2
