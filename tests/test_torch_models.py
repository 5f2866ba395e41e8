"""The port's two model families against the JAX package's.

Small sizes, as in tests/test_models.py. The same seeds give both packages
the same parameters (``init_params``), and ``interop.params_from_reference``
carries the JAX params across, so both forwards run on the same weights,
masks and inputs (the JAX side on the CPU's XLA backend, the port on its
plain versions). Tolerances: logits at rtol/atol 2e-4 (the JAX test's for
its sparse-vs-dense oracle); one step's loss at rtol 1e-5 and every
parameter's gradient at rtol 1e-3 and atol 1e-4 x that tensor's largest
|g|; three Adam steps (``torch.optim.Adam`` against ``optax.adam``) give
losses within 1e-3 relative. Updated parameters are not compared element
by element: Adam's first step is about lr * sign(g), so rounding noise in a
near-zero gradient flips an update of size lr."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (this worker's thread budget)

from bsmr_sddmm_tpu.config import SddmmConfig as JConfig
from bsmr_sddmm_tpu.formats import random_mask as j_random_mask
from bsmr_sddmm_tpu.models import graph_transformer as j_gt
from bsmr_sddmm_tpu.models import sparse_transformer as j_st

from bsmr_sddmm_tpu_torch import models
from bsmr_sddmm_tpu_torch.formats import random_mask
from bsmr_sddmm_tpu_torch.interop import (config_from_reference,
                                          params_from_reference)
from bsmr_sddmm_tpu_torch.models import graph_transformer as gt
from bsmr_sddmm_tpu_torch.models import sparse_transformer as st
from bsmr_sddmm_tpu_torch.models._common import layer_norm

SEQ = dict(model=dict(seq_len=256, vocab_size=64, head_dim=32, num_heads=2,
                      num_layers=1),
           cfg=dict(k=32, panel_height=16, dense_chunk=16,
                    residual_chunk=2048, delta=0.05),
           mask=dict(window=32, stride=64))
# tests/test_models.py::test_sparse_transformer_train_step
SEQ_TRAIN = dict(model=dict(seq_len=128, vocab_size=32, head_dim=16,
                            num_heads=2, num_layers=1),
                 cfg=dict(k=16, panel_height=16, dense_chunk=16,
                          residual_chunk=1024, delta=0.05),
                 mask=dict(window=16, stride=32))
GRAPH = dict(model=dict(num_nodes=384, feature_dim=16, head_dim=16,
                        num_heads=2, num_layers=2, num_classes=8),
             cfg=dict(k=16, panel_height=16, dense_chunk=16,
                      residual_chunk=2048, delta=0.05),
             mask=dict(rows=384, cols=384, nnz=6000, seed=5, block_rows=16,
                       block_cols=64))


class Family:
    """One model family built on both packages from one spec: the JAX
    forward, params and loss, and the port's net on the same weights."""

    def __init__(self, kind, spec):
        self.kind = kind
        jcfg = JConfig(**spec["cfg"])
        if kind == "sparse":
            self.jmodel = j_st.SparseTransformer(**spec["model"])
            jmask = j_st.local_strided_mask(self.jmodel.seq_len,
                                            **spec["mask"])
            mask = st.local_strided_mask(self.jmodel.seq_len, **spec["mask"])
            self.jfwd, self.jdplan, _ = j_st.make_forward(
                self.jmodel, mask=jmask, config=jcfg)
            self.jparams = j_st.init_params(self.jmodel)
            self.model = st.SparseTransformer(**spec["model"])
            self.net, self.dplan, self.plan = st.make_forward(
                self.model, mask=mask, config=config_from_reference(jcfg),
                params=params_from_reference(self.jparams), device="cpu")
            rng = np.random.default_rng(1)
            self.batch = (rng.integers(0, self.model.vocab_size,
                                       self.model.seq_len).astype(np.int32),)
            self.jtrain = j_st.make_train_step
            self.port = st
        else:
            self.jmodel = j_gt.GraphTransformer(**spec["model"])
            jcsr = j_random_mask(**spec["mask"])
            self.jfwd, self.jdplan, _ = j_gt.make_forward(
                self.jmodel, jcsr, config=jcfg)
            self.jparams = j_gt.init_params(self.jmodel)
            self.model = gt.GraphTransformer(**spec["model"])
            self.net, self.dplan, self.plan = gt.make_forward(
                self.model, random_mask(**spec["mask"]),
                config=config_from_reference(jcfg),
                params=params_from_reference(self.jparams), device="cpu")
            rng = np.random.default_rng(2)
            self.batch = (
                rng.normal(size=(self.model.num_nodes,
                                 self.model.feature_dim)).astype(np.float32),
                rng.integers(0, self.model.num_classes,
                             self.model.num_nodes).astype(np.int32))
            self.jtrain = j_gt.make_train_step
            self.port = gt

    def tbatch(self):
        return tuple(torch.from_numpy(x.copy()) for x in self.batch)

    def jax_logits(self):
        return np.asarray(jax.jit(self.jfwd)(
            self.jparams, jnp.asarray(self.batch[0]), self.jdplan))

    def jax_loss(self, params):
        """The loss of the JAX package's make_train_step."""
        if self.kind == "sparse":
            tokens = jnp.asarray(self.batch[0])
            logp = jax.nn.log_softmax(
                self.jfwd(params, tokens, self.jdplan)[:-1])
            nll = -jnp.take_along_axis(logp, tokens[1:, None], axis=1)
            return jnp.mean(nll)
        X, labels = (jnp.asarray(x) for x in self.batch)
        logp = jax.nn.log_softmax(self.jfwd(params, X, self.jdplan))
        onehot = jax.nn.one_hot(labels, self.jmodel.num_classes)
        return -jnp.mean(jnp.sum(onehot * logp, axis=-1))

    def port_loss(self):
        return self.port.loss_fn(self.net, *self.tbatch(), self.dplan)


def flat(tree, prefix=""):
    """A nested dict of arrays as {"a.b": array}."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = np.asarray(v)
    return out


FAMILIES = {"sparse": SEQ, "graph": GRAPH}


@pytest.mark.parametrize("args", [(512, 32, 64), (2048, 128, 64),
                                  (128, 16, 32), (100, 7, 200)])
def test_local_strided_mask_equals_reference(args):
    n, window, stride = args
    got = st.local_strided_mask(n, window=window, stride=stride)
    want = j_st.local_strided_mask(n, window=window, stride=stride)
    for name in ("row_offsets", "col_indices", "values"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
        assert getattr(got, name).dtype == getattr(want, name).dtype
    assert got.rows == want.rows and got.cols == want.cols


@pytest.mark.parametrize("kind", ["sparse", "graph"])
def test_init_params_equal_reference(kind):
    if kind == "sparse":
        spec = SEQ["model"]
        got = st.init_params(st.SparseTransformer(**spec), seed=3)
        want = j_st.init_params(j_st.SparseTransformer(**spec), seed=3)
    else:
        spec = GRAPH["model"]
        got = gt.init_params(gt.GraphTransformer(**spec), seed=3)
        want = j_gt.init_params(j_gt.GraphTransformer(**spec), seed=3)
    got, want = flat(got), flat(want)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == np.float32, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_params_from_reference_copies_the_tree():
    jparams = j_st.init_params(j_st.SparseTransformer(**SEQ["model"]))
    params = params_from_reference(jparams)
    assert set(params) == set(jparams)
    for name, v in flat(params).items():
        np.testing.assert_array_equal(v, flat(jparams)[name])
    params["layer_0"]["wq"] += 1.0
    assert not np.array_equal(flat(params)["layer_0.wq"],
                              np.asarray(jparams["layer_0"]["wq"]))


@pytest.mark.parametrize("kind", ["sparse", "graph"])
def test_forward_matches_reference(kind):
    fam = Family(kind, FAMILIES[kind])
    got = fam.net(*fam.tbatch()[:1], fam.dplan).detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, fam.jax_logits(), rtol=2e-4, atol=2e-4)


def test_sparse_transformer_matches_attention_oracle():
    """Layer 0's attention output against masked dense attention, as
    tests/test_models.py holds the JAX model."""
    fam = Family("sparse", SEQ)
    net, model = fam.net, fam.model
    n, h, hd = model.seq_len, model.num_heads, model.head_dim
    tokens = fam.tbatch()[0]
    with torch.no_grad():
        x = net.embed.index_select(0, tokens) + net.pos
        lp = net.layer_0
        xn = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
        got = x + net.attention(lp, xn, fam.dplan)
        q = (xn @ lp["wq"]).reshape(n, h, hd)
        k = (xn @ lp["wk"]).reshape(n, h, hd)
        v = (xn @ lp["wv"]).reshape(n, h, hd)
        mask = st.local_strided_mask(n, **SEQ["mask"])
        dense_mask = torch.zeros(n, n, dtype=torch.bool)
        dense_mask[mask.coo_rows(), mask.col_indices] = True
        logits = torch.einsum("qhd,khd->hqk", q, k) / np.sqrt(hd)
        alpha = torch.softmax(logits.masked_fill(~dense_mask, -torch.inf),
                              dim=-1)
        want = x + torch.einsum("hqk,khd->qhd", alpha, v).reshape(
            n, h * hd) @ lp["wo"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("kind", ["sparse", "graph"])
def test_one_step_loss_and_gradients_match_reference(kind):
    fam = Family(kind, FAMILIES[kind])
    jloss, jgrads = jax.jit(jax.value_and_grad(fam.jax_loss))(fam.jparams)
    loss = fam.port_loss()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jgrads = flat(jgrads)
    names = [name for name, _ in fam.net.named_parameters()]
    assert sorted(names) == sorted(jgrads)
    for name, p in fam.net.named_parameters():
        want = jgrads[name]
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=1e-3,
            atol=1e-4 * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("kind", ["sparse", "graph"])
def test_adam_steps_match_optax(kind):
    spec = SEQ_TRAIN if kind == "sparse" else GRAPH
    fam = Family(kind, spec)
    opt_init, step = fam.port.make_train_step(fam.model, fam.net)
    opt = opt_init()
    j_init, j_step = fam.jtrain(fam.jmodel, fam.jfwd)
    j_step = jax.jit(j_step)
    params, state = fam.jparams, j_init(fam.jparams)
    jbatch = tuple(jnp.asarray(x) for x in fam.batch)
    for _ in range(3):
        params, state, jloss = j_step(params, state, *jbatch, fam.jdplan)
        loss = step(opt, *fam.tbatch(), fam.dplan)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)


@pytest.mark.parametrize("kind", ["sparse", "graph"])
def test_train_steps_lower_the_loss(kind):
    """Three steps on one batch lower the loss, the JAX test's criterion."""
    spec = SEQ_TRAIN if kind == "sparse" else GRAPH
    fam = Family(kind, spec)
    opt_init, step = fam.port.make_train_step(fam.model, fam.net)
    opt = opt_init()
    losses = [float(step(opt, *fam.tbatch(), fam.dplan)) for _ in range(3)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_models_run_on_the_card_unless_told(monkeypatch):
    """Without a card and without device='cpu' the entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = st.SparseTransformer(**SEQ_TRAIN["model"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.make_forward(model, window=16, stride=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gt.make_forward(gt.GraphTransformer(**GRAPH["model"]),
                        random_mask(**GRAPH["mask"]))


def test_models_package_exports_match_reference():
    import bsmr_sddmm_tpu.models as j_models
    assert sorted(models.__all__) == sorted(j_models.__all__)
    assert models.make_forward is gt.make_forward
    assert models.sparse_transformer is st
