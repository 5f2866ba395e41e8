"""The training path on a CUDA device: the autograd SDDMM body, the
attention head and the sparse transformer through the hand kernels against
the same built on the plain versions; a captured CUDA graph of the rphm
body against eager calls; the head with TF32 on against it off; the
batched SDDMM, the tier chunks and the replayed-graph timing of
``BsmrSddmm.benchmark``.

Every test here needs the card (marker ``cuda``) and imports nothing of JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py``.

Tolerances: the kernels compute three TF32 passes where the plain versions
take fp32 products (agreeing to a few fp32 ulps of each sum), and
``index_add`` on the card sums in no fixed order. Head outputs and logits
are held at rtol/atol 1e-4, gradients at rtol 1e-3 and atol 1e-4 x that
tensor's largest |g| (the CPU tests' tolerance against JAX). A graph
replay, and the batched SDDMM against single calls, run the same kernels
on the same inputs and must agree bit for bit."""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (this worker's thread budget)

import bsmr_sddmm_tpu_torch as bt
from bsmr_sddmm_tpu_torch.formats import random_mask
from bsmr_sddmm_tpu_torch.models import sparse_transformer as st
from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.ops.graph_rphm import make_sparse_attention_rphm
from bsmr_sddmm_tpu_torch.ops.sddmm import (device_plan,
                                            make_batched_sddmm_fn,
                                            make_sddmm_body)

SMALL = dict(rows=512, cols=768, nnz=20000, seed=7, block_rows=24,
             block_cols=96)
BASE = dict(k=128, panel_height=16, dense_chunk=64, residual_chunk=4096,
            subpack_min_nnz=12)
CASES = {
    "bsr": dict(delta=0.05),
    "bsr_g1_fp16": dict(delta=0.05, dense_fat_group=1, out_dtype="float16"),
    "reorder_fused": dict(delta=0.1, col_mode="reorder",
                          gathered_backend="fused"),
    "chunked": dict(delta=0.05, tier_memory_mb=0),
}


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none (decided here,
    at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the GPU run python -m pytest "
                    "--noconftest -m cuda tests/test_torch_train_cuda.py")
    return torch.device("cuda")


def build(case, device):
    """A plan of the SMALL mask for ``case``, its config, the full device
    plan and normal (mixed-sign) operands A, Bt on ``device``."""
    csr = random_mask(**SMALL)
    cfg = bt.SddmmConfig(**BASE, **CASES[case])
    plan = bt.BsmrSddmm(csr, cfg, device=device).plan()
    rng = np.random.default_rng(4)
    A, Bt = (torch.from_numpy(rng.standard_normal((n, cfg.k)).astype(
        np.float32)).to(device) for n in (csr.rows, csr.cols))
    return csr, cfg, plan, device_plan(plan, device), A, Bt


def launches():
    return {name: getattr(dk, name).launches
            for name in ("bsr_dense", "subpack", "dense_tile",
                         "fused_gathered", "residual")}


def assert_grads_close(got, want):
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_rphm_body_graph_replay_equals_eager(cuda, case):
    _, cfg, plan, dplan, A, Bt = build(case, cuda)
    body = make_sddmm_body(plan, cfg, emit="rphm")
    eager = body(A, Bt, dplan)             # builds the kernels
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(A, Bt, dplan)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = body(A, Bt, dplan)
    before = launches()
    graph.replay()
    torch.cuda.synchronize()
    assert launches() == before          # a replay counts no launch
    for tier, e, c in zip(("dense", "packed", "gathered", "residual"),
                          eager, captured):
        assert torch.equal(e, c), tier


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bsr", "reorder_fused"])
def test_attention_head_gradients_with_kernels_match_plain(cuda, case):
    csr, cfg, plan, dplan, _, _ = build(case, cuda)
    rng = np.random.default_rng(6)
    inputs = [rng.standard_normal((n, cfg.k)).astype(np.float32)
              for n in (csr.rows, csr.cols, csr.cols)]
    w = torch.from_numpy(rng.standard_normal((csr.rows, cfg.k)).astype(
        np.float32)).to(cuda)
    results = []
    for backend in ("auto", "torch"):
        head = make_sparse_attention_rphm(
            plan, make_sddmm_body(plan, cfg, backend, emit="rphm"))
        q, k, v = (torch.from_numpy(x).to(cuda).requires_grad_()
                   for x in inputs)
        before = launches()
        out = head(q, k, v, dplan)
        (out * w).sum().backward()
        ran = {n: launches()[n] - before[n] for n in before}
        results.append((out.detach(), (q.grad, k.grad, v.grad), ran))
    (out_k, grads_k, ran_k), (out_p, grads_p, ran_p) = results
    tile_kernel = "bsr_dense" if plan.mode == "bsr" else "dense_tile"
    assert ran_k[tile_kernel] == 1 and ran_k["subpack"] == 1
    assert ran_k["residual"] == int(plan.res_arow.shape[0] > 0)
    assert not any(ran_p.values())
    torch.testing.assert_close(out_k, out_p, rtol=1e-4, atol=1e-4)
    assert_grads_close(grads_k, grads_p)


@pytest.mark.cuda
def test_attention_head_ignores_allow_tf32(cuda):
    """The head's output and gradients with TF32 switched on in the
    caller's process equal those with it off, to index_add's ordering
    noise (rtol 1e-5, atol 1e-5 x max|g|; TF32 products would be ~1e-3
    off), and every call leaves the caller's setting as it found it."""
    csr, cfg, plan, dplan, _, _ = build("bsr", cuda)
    rng = np.random.default_rng(9)
    inputs = [rng.standard_normal((n, cfg.k)).astype(np.float32)
              for n in (csr.rows, csr.cols, csr.cols)]
    w = torch.from_numpy(rng.standard_normal((csr.rows, cfg.k)).astype(
        np.float32)).to(cuda)
    head = make_sparse_attention_rphm(
        plan, make_sddmm_body(plan, cfg, emit="rphm"))
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    results = []
    try:
        for tf32 in (False, True):
            flags.allow_tf32 = tf32
            q, k, v = (torch.from_numpy(x).to(cuda).requires_grad_()
                       for x in inputs)
            out = head(q, k, v, dplan)
            assert flags.allow_tf32 == tf32
            (out * w).sum().backward()
            assert flags.allow_tf32 == tf32
            results.append([out.detach(), q.grad, k.grad, v.grad])
    finally:
        flags.allow_tf32 = before
    for name, off, on in zip(("out", "dq", "dk", "dv"), *results):
        torch.testing.assert_close(on, off, rtol=1e-5,
                                   atol=1e-5 * float(off.abs().max()),
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
def test_sparse_transformer_trains_through_the_kernels(cuda):
    model = st.SparseTransformer(seq_len=512, vocab_size=64, head_dim=128,
                                 num_heads=2, num_layers=1)
    cfg = bt.SddmmConfig(k=128, delta=0.05)
    nets = [st.make_forward(model, config=cfg.replace(backend=b),
                            window=128, stride=64, device=cuda)
            for b in ("auto", "torch")]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, 512)).to(cuda)
    grads = []
    for net, dplan, plan in nets:
        assert plan.num_tiles and plan.fat_group > 1
        before = launches()
        loss = st.loss_fn(net, tokens, dplan)
        loss.backward()
        ran = launches()["bsr_dense"] - before["bsr_dense"]
        assert ran == (model.num_heads if net is nets[0][0] else 0)
        grads.append([p.grad for _, p in net.named_parameters()])
    assert_grads_close(*grads)
    net, dplan, _ = nets[0]
    opt_init, step = st.make_train_step(model, net)
    opt = opt_init()
    losses = [float(step(opt, tokens, dplan)) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.cuda
@pytest.mark.parametrize("emit", ["csr", "rphm"])
def test_batched_sddmm_equals_single_calls(cuda, emit):
    csr, cfg, plan, dplan, _, _ = build("bsr", cuda)
    rng = np.random.default_rng(8)
    Z = 3
    A = torch.from_numpy(rng.random((Z, csr.rows, cfg.k), np.float32)).to(
        cuda)
    Bt = torch.from_numpy(rng.random((Z, csr.cols, cfg.k), np.float32)).to(
        cuda)
    before = launches()["bsr_dense"]
    got = make_batched_sddmm_fn(plan, cfg, emit=emit)(A, Bt, dplan)
    assert launches()["bsr_dense"] - before == Z
    body = make_sddmm_body(plan, cfg, emit=emit)
    for z in range(Z):
        one = body(A[z], Bt[z], dplan)
        if emit == "csr":
            assert torch.equal(got[z], one)
        else:
            assert all(torch.equal(g[z], o) for g, o in zip(got, one))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["gathered", "residual"])
def test_tier_chunks_on_the_card(cuda, tier):
    _, cfg, plan, dplan, A, Bt = build("bsr", cuda)
    one = make_sddmm_body(plan, cfg, only_tier=tier)(A, Bt, dplan)
    chunked = make_sddmm_body(plan, cfg.replace(tier_memory_mb=0),
                              only_tier=tier)(A, Bt, dplan)
    torch.testing.assert_close(chunked, one, rtol=1e-6, atol=1e-5)


@pytest.mark.cuda
def test_benchmark_times_the_replayed_graph(cuda):
    csr = random_mask(**SMALL)
    cfg = bt.SddmmConfig(**BASE, delta=0.05, num_iterations=4)
    A = bt.make_dense(csr.rows, cfg.k, seed=1337)
    B = bt.make_dense(cfg.k, csr.cols, seed=1338)
    before = launches()["bsr_dense"]
    log = bt.BsmrSddmm(csr, cfg, device=cuda).benchmark(
        A, B, validate=True, tier_times=True)
    assert log.check_result == "pass"
    assert launches()["bsr_dense"] > before     # the warm-up calls
    for key in ("sddmm_eager_ms", "sddmm_csr_ms", "tier_dense_ms",
                "tier_residual_ms"):
        assert float(log.extras[key]) > 0, key
    assert log.sddmm_ms > 0
