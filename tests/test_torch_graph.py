"""The port's graph ops, autograd SDDMM body, tier chunks and batched SDDMM
against the JAX package's.

One TilePlan, packed by the JAX package and carried across with
``interop.plan_from_reference``, and the same NumPy inputs go to both
packages, at the sizes of tests/test_graph_rphm.py (whose eight tests are
mirrored here, with its delta parameters). The JAX side runs
``backend="xla"`` on the CPU, as its own tests do; the port runs its plain
versions on CPU tensors. Both sides are fp32 and differ in the order of
their sums: tile-layout ops are held to the JAX ones at rtol 1e-5 / atol
1e-5 (softmax probabilities at atol 1e-6), SpMM outputs (sums of ~40
products of values up to ~100) at rtol 1e-5 / atol 1e-4, and the results
against the CSR oracles or scipy at the JAX tests' own 2e-4. Gradients of
the autograd body are held to ``jax.grad`` through the JAX custom VJP at
rtol/atol 3e-4, the JAX test's tolerance, and so are the SpMM's own
backward and one attention head's, against ``jax.grad`` through the JAX
SpMM and head. Tier chunks (``tier_memory_mb``)
must equal the single shot bit for bit."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import _torch_threads  # noqa: F401  (this worker's thread budget)

import bsmr_sddmm_tpu.ops.graph as j_graph
import bsmr_sddmm_tpu.ops.graph_rphm as j_graph_rphm
import bsmr_sddmm_tpu.ops.sddmm as jops
import bsmr_sddmm_tpu.ops.spmm as j_spmm
from bsmr_sddmm_tpu.config import SddmmConfig as JConfig
from bsmr_sddmm_tpu.formats import make_dense
from bsmr_sddmm_tpu.formats import random_mask as j_random_mask
from bsmr_sddmm_tpu.pack import pack_tiles as j_pack_tiles
from bsmr_sddmm_tpu.reorder import bsmr as j_bsmr
from bsmr_sddmm_tpu.utils.checkdata import check_data

from bsmr_sddmm_tpu_torch.formats import random_mask
from bsmr_sddmm_tpu_torch.interop import (config_from_reference,
                                          plan_from_reference)
from bsmr_sddmm_tpu_torch.ops import graph, graph_rphm
from bsmr_sddmm_tpu_torch.ops import sddmm as tops
from bsmr_sddmm_tpu_torch.ops import spmm as t_spmm
from bsmr_sddmm_tpu_torch.ops.sddmm import (device_plan,
                                            make_batched_sddmm_fn,
                                            make_sddmm_body, sddmm_ref)

from tests.conftest import make_ab

TIERS = ("dense", "packed", "gathered", "residual")


def setup(delta=0.05, rows=512, cols=768, nnz=20000, seed=7,
          col_mode="bsr", **cfg_kw):
    """The JAX package's mask, config, plan and device plan, and the
    port's copies (the sizes of tests/test_graph_rphm.py::_setup)."""
    spec = dict(rows=rows, cols=cols, nnz=nnz, seed=seed, block_rows=24,
                block_cols=96)
    jcsr = j_random_mask(**spec)
    jcfg = JConfig(k=32, panel_height=16, dense_chunk=16,
                   residual_chunk=2048, delta=delta, col_mode=col_mode,
                   **cfg_kw)
    jplan = j_pack_tiles(jcsr, j_bsmr(jcsr, jcfg), jcfg)
    plan = plan_from_reference(jplan)
    return types.SimpleNamespace(
        jcsr=jcsr, jcfg=jcfg, jplan=jplan, jdplan=jops.device_plan(jplan),
        csr=random_mask(**spec), cfg=config_from_reference(jcfg), plan=plan,
        dplan=device_plan(plan, "cpu"))


def t(x):
    """A CPU tensor holding a copy of ``x`` (NumPy or JAX)."""
    return torch.from_numpy(np.array(x))


def j_rphm(c, A, Bt):
    """The JAX body's four tiers on (A, Bt), as NumPy arrays."""
    body = jops.make_sddmm_body(c.jplan, c.jcfg, backend="xla", emit="rphm")
    return [np.asarray(x) for x in jax.jit(body)(
        jnp.asarray(A), jnp.asarray(Bt), c.jdplan)]


def scores(c):
    A, B = make_ab(c.jcsr, c.jcfg.k)
    return j_rphm(c, A, np.ascontiguousarray(B.T))


def csr_values(c, tiers):
    return c.plan.csr_values_from_rphm(*[np.asarray(x) for x in tiers])


def scipy_matrix(csr, vals):
    return sp.csr_matrix((vals, csr.col_indices, csr.row_offsets),
                         shape=(csr.rows, csr.cols))


# ---------------------------------------------------------------------------
# tests/test_graph_rphm.py, mirrored
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("delta", [0.006, 0.05, 1.1])
def test_edge_softmax_rphm_matches_reference(delta):
    c = setup(delta=delta)
    d, pk, g, r = scores(c)
    want = jax.jit(j_graph_rphm.make_edge_softmax_rphm(c.jplan))(
        d, pk, g, r, c.jdplan)
    got = graph_rphm.make_edge_softmax_rphm(c.plan)(
        t(d), t(pk), t(g), t(r), c.dplan)
    for tier, w, x in zip(TIERS, want, got):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=tier)
    # and against the port's CSR oracle, as the JAX test holds its own
    seg = torch.from_numpy(graph.csr_segment_ids(c.csr))
    csr_soft = graph.edge_softmax(t(csr_values(c, (d, pk, g, r))), seg,
                                  c.csr.rows)
    np.testing.assert_allclose(csr_values(c, got), csr_soft.numpy(),
                               rtol=1e-5, atol=1e-6)
    j_soft = j_graph.edge_softmax(
        jnp.asarray(csr_values(c, (d, pk, g, r))),
        jnp.asarray(graph.csr_segment_ids(c.csr)), c.csr.rows)
    np.testing.assert_allclose(csr_soft.numpy(), np.asarray(j_soft),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("delta", [0.006, 1.1])
def test_spmm_rphm_matches_reference(delta):
    c = setup(delta=delta)
    d, pk, g, r = scores(c)
    V = make_dense(c.csr.cols, 24, seed=99)
    want = np.asarray(jax.jit(j_graph_rphm.make_spmm_rphm(c.jplan))(
        d, pk, g, r, jnp.asarray(V), c.jdplan))
    got = graph_rphm.make_spmm_rphm(c.plan)(
        t(d), t(pk), t(g), t(r), t(V), c.dplan).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    vals = csr_values(c, (d, pk, g, r))
    oracle = graph.spmm(t(vals), torch.from_numpy(c.csr.col_indices),
                        torch.from_numpy(graph.csr_segment_ids(c.csr)),
                        t(V), c.csr.rows).numpy()
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)
    j_oracle = j_graph.spmm(jnp.asarray(vals),
                            jnp.asarray(c.csr.col_indices.astype(np.int32)),
                            jnp.asarray(graph.csr_segment_ids(c.csr)),
                            jnp.asarray(V), c.csr.rows)
    np.testing.assert_allclose(oracle, np.asarray(j_oracle), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("precision", ["default", "high"])
def test_graph_ops_at_each_precision_match_reference(precision,
                                                     monkeypatch):
    """The SpMM and one attention head (its body at the same
    matmul_precision) against the JAX ones at that precision, at the
    check_data tolerance; the SpMMs' bmm take one TF32 pass only at
    "default", and the caller's flag is put back."""
    c = setup(delta=0.05)
    d, pk, g, r = scores(c)
    V = make_dense(c.csr.cols, 24, seed=99)
    want = np.asarray(jax.jit(j_graph_rphm.make_spmm_rphm(
        c.jplan, precision))(d, pk, g, r, jnp.asarray(V), c.jdplan))
    flags = []
    real_bmm = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda a, b: flags.append(
        torch.backends.cuda.matmul.allow_tf32) or real_bmm(a, b))
    got = graph_rphm.make_spmm_rphm(c.plan, precision)(
        t(d), t(pk), t(g), t(r), t(V), c.dplan).numpy()
    assert flags and set(flags) == {precision == "default"}
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert check_data(want, got).passed
    monkeypatch.setattr(torch, "bmm", real_bmm)
    q, k, v = (make_dense(n, c.cfg.k, seed=s) for n, s in
               ((c.csr.rows, 3), (c.csr.cols, 4), (c.csr.cols, 6)))
    jcfg = c.jcfg.replace(matmul_precision=precision)
    want = np.asarray(j_graph_rphm.make_sparse_attention_rphm(
        c.jplan, jops.make_sddmm_body(c.jplan, jcfg, emit="rphm"),
        precision)(*map(jnp.asarray, (q, k, v)), c.jdplan))
    got = graph_rphm.make_sparse_attention_rphm(
        c.plan, make_sddmm_body(
            c.plan, c.cfg.replace(matmul_precision=precision), emit="rphm"),
        precision)(t(q), t(k), t(v), c.dplan).numpy()
    assert check_data(want, got).passed
    with pytest.raises(ValueError, match="matmul_precision"):
        graph_rphm.make_spmm_rphm(c.plan, "fp8")


def test_fused_attention_head_matches_reference():
    c = setup()
    rng = np.random.default_rng(3)
    q = rng.normal(size=(c.csr.rows, c.cfg.k)).astype(np.float32)
    k = rng.normal(size=(c.csr.cols, c.cfg.k)).astype(np.float32)
    v = rng.normal(size=(c.csr.cols, 16)).astype(np.float32)
    j_body = jops.make_sddmm_body(c.jplan, c.jcfg, emit="rphm")
    want = np.asarray(jax.jit(j_graph_rphm.make_sparse_attention_rphm(
        c.jplan, j_body))(q, k, v, c.jdplan))
    head = graph_rphm.make_sparse_attention_rphm(
        c.plan, make_sddmm_body(c.plan, c.cfg, emit="rphm"))
    got = head(t(q), t(k), t(v), c.dplan).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the CSR path: SDDMM in CSR order, CSR softmax, CSR SpMM
    seg = torch.from_numpy(graph.csr_segment_ids(c.csr))
    col = torch.from_numpy(c.csr.col_indices)
    s = make_sddmm_body(c.plan, c.cfg, emit="csr")(t(q), t(k), c.dplan)
    alpha = graph.edge_softmax(s / np.sqrt(c.cfg.k), seg, c.csr.rows)
    oracle = graph.spmm(alpha, col, seg, t(v), c.csr.rows).numpy()
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


def test_spmm_rphm_empty_rows():
    """Rows with no nonzeros come back exactly zero, on both sides."""
    c = setup(nnz=900, rows=96, cols=160, seed=3)
    empty = np.nonzero(c.csr.row_nnz() == 0)[0]
    assert empty.size, "the mask has empty rows"
    d, pk, g, r = scores(c)
    V = make_dense(c.csr.cols, 8, seed=1)
    got = graph_rphm.make_spmm_rphm(c.plan)(
        t(d), t(pk), t(g), t(r), t(V), c.dplan).numpy()
    want = np.asarray(j_graph_rphm.make_spmm_rphm(c.jplan)(
        d, pk, g, r, jnp.asarray(V), c.jdplan))
    np.testing.assert_array_equal(got[empty], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def weights(plan, seed=5):
    """Random cotangents shaped like the body's four tiers."""
    rng = np.random.default_rng(seed)
    ph, bw = plan.panel_height, plan.block_width
    shapes = [(plan.tile_panel.shape[0], ph, bw),
              (plan.sp_panel.shape[0], ph, bw),
              (plan.g_panel.shape[0], ph, bw), (plan.res_arow.shape[0],)]
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def real(plan, w):
    """``w`` with every slot that holds no nonzero set to 0."""
    maps = (plan.tile_scatter, plan.sp_scatter, plan.g_scatter, plan.res_out)
    return [np.where(m < plan.nnz, x, 0.0).astype(np.float32)
            for m, x in zip(maps, w)]


def port_grads(c, A, Bt, w):
    """dA, dBt of sum(tiers . w) through the port's autograd body."""
    body = make_sddmm_body(c.plan, c.cfg, emit="rphm")
    diff = graph_rphm.make_diff_sddmm_body(c.plan, body)
    A_t, Bt_t = t(A).requires_grad_(), t(Bt).requires_grad_()
    loss = sum((x * t(wi)).sum() for x, wi in zip(diff(A_t, Bt_t, c.dplan),
                                                   w))
    loss.backward()
    return A_t.grad.numpy(), Bt_t.grad.numpy()


def jax_grads(c, A, Bt, w):
    """dA, dBt through the JAX package's custom VJP."""
    body = jops.make_sddmm_body(c.jplan, c.jcfg, emit="rphm")
    diff = j_graph_rphm.make_diff_sddmm_body(c.jplan, body)

    def loss(a, b):
        return sum(jnp.vdot(x, wi) for x, wi in zip(diff(a, b, c.jdplan), w))

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(A), jnp.asarray(Bt))]


def test_diff_sddmm_gradients_match_autograd():
    """The autograd body's gradients against autograd through the plain
    body (differentiable on CPU tensors), cotangents on real slots."""
    c = setup()
    rng = np.random.default_rng(5)
    A = rng.normal(size=(c.csr.rows, c.cfg.k)).astype(np.float32)
    Bt = rng.normal(size=(c.csr.cols, c.cfg.k)).astype(np.float32)
    w = real(c.plan, weights(c.plan))
    gA, gB = port_grads(c, A, Bt, w)
    A_t, Bt_t = t(A).requires_grad_(), t(Bt).requires_grad_()
    plain = make_sddmm_body(c.plan, c.cfg, emit="rphm")(A_t, Bt_t, c.dplan)
    sum((x * t(wi)).sum() for x, wi in zip(plain, w)).backward()
    np.testing.assert_allclose(gA, A_t.grad.numpy(), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(gB, Bt_t.grad.numpy(), rtol=3e-4, atol=3e-4)


def test_spmm_rphm_reorder_mode_matches_scipy():
    c = setup(delta=0.3, col_mode="reorder")
    assert c.plan.tile_cblock is None and c.plan.num_tiles > 0
    vals = np.random.default_rng(13).normal(size=c.csr.nnz).astype(
        np.float32)
    c.csr.values[:] = vals
    c.jcsr.values[:] = vals
    V = make_dense(c.csr.cols, 24, seed=21)
    got = t_spmm.spmm(c.csr, c.plan, V, device="cpu")
    np.testing.assert_allclose(got, scipy_matrix(c.csr, vals) @ V,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, j_spmm.spmm(c.jcsr, c.jplan, V),
                               rtol=1e-5, atol=1e-5)


def test_spmm_transpose_rphm_reorder_mode_matches_scipy():
    c = setup(delta=0.3, col_mode="reorder")
    assert c.plan.tile_cblock is None and c.plan.num_tiles > 0
    vals = np.random.default_rng(17).normal(size=c.csr.nnz).astype(
        np.float32)
    tiers = t_spmm.pack_values_rphm(c.plan, vals)
    for mine, ref in zip(tiers, j_spmm.pack_values_rphm(c.jplan, vals)):
        np.testing.assert_array_equal(mine, ref)
    A = make_dense(c.csr.rows, 16, seed=23)
    got = graph_rphm.make_spmm_transpose_rphm(c.plan)(
        *[t(x) for x in tiers], t(A), c.dplan).numpy()
    np.testing.assert_allclose(got, scipy_matrix(c.csr, vals).T @ A,
                               rtol=2e-4, atol=2e-4)
    want = j_graph_rphm.make_spmm_transpose_rphm(c.jplan)(
        *[jnp.asarray(x) for x in tiers], jnp.asarray(A), c.jdplan)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_public_spmm_matches_scipy():
    c = setup()
    vals = np.random.default_rng(11).normal(size=c.csr.nnz).astype(
        np.float32)
    c.csr.values[:] = vals
    c.jcsr.values[:] = vals
    V = make_dense(c.csr.cols, 24, seed=2)
    got = t_spmm.spmm(c.csr, c.plan, V, device="cpu")
    np.testing.assert_allclose(got, scipy_matrix(c.csr, vals) @ V,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, j_spmm.spmm(c.jcsr, c.jplan, V),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# gradients against JAX's (custom VJP and autodiff); the full-plan rule
# ---------------------------------------------------------------------------

def setup_mode(mode):
    """A bsr plan at G > 1 or a reorder plan, every tier non-empty."""
    c = (setup(delta=0.05) if mode == "bsr_fat"
         else setup(delta=0.3, col_mode="reorder"))
    assert c.plan.num_tiles and c.plan.num_packed and c.plan.num_gathered
    if mode == "bsr_fat":
        assert c.plan.fat_group > 1
    else:
        assert c.plan.mode == "reorder"
    return c


@pytest.mark.parametrize("mode", ["bsr_fat", "reorder"])
def test_diff_sddmm_gradients_match_jax(mode):
    c = setup_mode(mode)
    rng = np.random.default_rng(5)
    A = rng.normal(size=(c.csr.rows, c.cfg.k)).astype(np.float32)
    Bt = rng.normal(size=(c.csr.cols, c.cfg.k)).astype(np.float32)
    w = weights(c.plan, seed=9)
    for got, want in zip(port_grads(c, A, Bt, w), jax_grads(c, A, Bt, w)):
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("mode", ["bsr_fat", "reorder"])
def test_spmm_rphm_gradients_match_jax(mode):
    """The SpMM's own backward (values and V) against jax.grad through the
    JAX SpMM, which autodiff differentiates as it is."""
    c = setup_mode(mode)
    vals = weights(c.plan, seed=12)
    V = make_dense(c.csr.cols, 24, seed=31)
    W = np.random.default_rng(14).normal(size=(c.csr.rows, 24)).astype(
        np.float32)
    j_spmm_fn = j_graph_rphm.make_spmm_rphm(c.jplan)

    def j_loss(d, p, g, r, v):
        return jnp.vdot(j_spmm_fn(d, p, g, r, v, c.jdplan), W)

    want = jax.grad(j_loss, argnums=tuple(range(5)))(
        *[jnp.asarray(x) for x in vals + [V]])
    inputs = [t(x).requires_grad_() for x in vals + [V]]
    out = graph_rphm.make_spmm_rphm(c.plan)(*inputs, c.dplan)
    (out * t(W)).sum().backward()
    for name, x, w in zip(TIERS + ("V",), inputs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=3e-4,
                                   atol=3e-4, err_msg=name)


@pytest.mark.parametrize("mode", ["bsr_fat", "reorder"])
def test_attention_head_gradients_match_jax(mode):
    """dq, dk, dv of one attention head (SDDMM, softmax, SpMM) against
    jax.grad through the JAX head."""
    c = setup_mode(mode)
    rng = np.random.default_rng(15)
    q, k, v = (rng.normal(size=(n, c.cfg.k)).astype(np.float32)
               for n in (c.csr.rows, c.csr.cols, c.csr.cols))
    W = rng.normal(size=(c.csr.rows, c.cfg.k)).astype(np.float32)
    j_head = j_graph_rphm.make_sparse_attention_rphm(
        c.jplan, jops.make_sddmm_body(c.jplan, c.jcfg, emit="rphm"))
    want = jax.grad(lambda *x: jnp.vdot(j_head(*x, c.jdplan), W),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    head = graph_rphm.make_sparse_attention_rphm(
        c.plan, make_sddmm_body(c.plan, c.cfg, emit="rphm"))
    inputs = [t(x).requires_grad_() for x in (q, k, v)]
    (head(*inputs, c.dplan) * t(W)).sum().backward()
    for name, x, w in zip("qkv", inputs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=3e-4,
                                   atol=3e-4, err_msg=name)


def test_graph_ops_refuse_the_light_plan():
    c = setup(nnz=900, rows=96, cols=160, seed=3)
    light = device_plan(c.plan, "cpu", emit="rphm")
    tiers = [t(x) for x in scores(c)]
    V = t(make_dense(c.csr.cols, 8, seed=1))
    body = make_sddmm_body(c.plan, c.cfg, emit="rphm")
    calls = [
        lambda: graph_rphm.make_edge_softmax_rphm(c.plan)(*tiers, light),
        lambda: graph_rphm.make_spmm_rphm(c.plan)(*tiers, V, light),
        lambda: graph_rphm.make_spmm_transpose_rphm(c.plan)(*tiers, V,
                                                            light),
        lambda: graph_rphm.make_diff_sddmm_body(c.plan, body)(V, V, light)]
    for call in calls:
        with pytest.raises(ValueError, match="full device plan"):
            call()


# ---------------------------------------------------------------------------
# tier chunks (tier_memory_mb) and the batched SDDMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier,cfg_kw", [
    ("gathered", dict(delta=0.05)),
    ("residual", dict(delta=1.1, residual_mode="pernnz"))])
def test_tier_chunks_equal_single_shot(tier, cfg_kw):
    c = setup(**cfg_kw)
    n = (c.plan.g_panel.shape[0] if tier == "gathered"
         else c.plan.res_arow.shape[0])
    want = (c.cfg.dense_chunk if tier == "gathered"
            else c.cfg.residual_chunk)
    assert tops._big_chunk(n, want) < n, "the tier runs in several chunks"
    A, B = make_ab(c.csr, c.cfg.k)
    A, Bt = t(A), t(np.ascontiguousarray(B.T))
    dplan = device_plan(c.plan, "cpu", emit="rphm")
    one = make_sddmm_body(c.plan, c.cfg, only_tier=tier)(A, Bt, dplan)
    chunked = make_sddmm_body(c.plan, c.cfg.replace(tier_memory_mb=0),
                              only_tier=tier)(A, Bt, dplan)
    assert torch.equal(one, chunked)
    # the JAX body chunks the same tier at the same budget
    jbody = jops.make_sddmm_body(c.jplan, c.jcfg.replace(tier_memory_mb=0),
                                 backend="xla", only_tier=tier)
    ref = np.asarray(jbody(jnp.asarray(A.numpy()), jnp.asarray(Bt.numpy()),
                           c.jdplan))
    np.testing.assert_allclose(chunked.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("emit", ["csr", "rphm"])
def test_batched_sddmm_matches_reference(tiny_mask, cfg, emit):
    Z = 3
    jplan = j_pack_tiles(tiny_mask, j_bsmr(tiny_mask, cfg), cfg)
    plan = plan_from_reference(jplan)
    A = np.stack([make_dense(tiny_mask.rows, cfg.k, seed=i)
                  for i in range(Z)])
    B = np.stack([make_dense(cfg.k, tiny_mask.cols, seed=100 + i)
                  for i in range(Z)])
    Bt = np.ascontiguousarray(B.transpose(0, 2, 1))
    ref = jops.make_batched_sddmm_fn(jplan, cfg, emit=emit)(
        jnp.asarray(A), jnp.asarray(Bt), jops.device_plan(jplan))
    fn = make_batched_sddmm_fn(plan, config_from_reference(cfg), emit=emit)
    got = fn(t(A), t(Bt), device_plan(plan, "cpu"))
    if emit == "csr":
        assert got.shape == (Z, tiny_mask.nnz)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
        for z in range(Z):
            res = check_data(sddmm_ref(A[z], B[z], tiny_mask), got[z].numpy())
            assert res.passed, f"batch {z}"
        return
    maps = (plan.tile_scatter, plan.sp_scatter, plan.g_scatter, plan.res_out)
    for tier, m, r, g in zip(TIERS, maps, ref, got):
        assert g.shape == (Z,) + m.shape, tier
        real_slots = np.broadcast_to(m < plan.nnz, g.shape)
        np.testing.assert_allclose(g.numpy()[real_slots],
                                   np.asarray(r)[real_slots], rtol=1e-5,
                                   atol=1e-5, err_msg=tier)
