"""The parallel layer on a CUDA device: the sharded SDDMM (B replicated and
b-sharded, the fused gathered tier), the ring, ``emit="csr_scatter"`` and
both model families' train step over the mesh through the hand kernels,
and the graft entry points (``graft_entry``), against the same built on
the plain versions (``backend="torch"``), on a mesh of four shards on the
first card (eight for ``dryrun_multichip(8)``).

Every test here needs the card (marker ``cuda``) and imports nothing of JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py``.

Tolerances: the kernels compute three TF32 passes where the plain versions
take fp32 products, agreeing to a few fp32 ulps of each sum: rtol 1e-5 +
atol 1e-4 on values in [0, 2) at K = 128, as chip_smoke.py holds them;
against the fp64 oracle check_data (abs 1e-5 OR rel 1e-3). The train step:
logits at rtol/atol 2e-4 and every gradient at rtol 1e-3 + atol 1e-4 x
that tensor's largest |g| (``index_add`` on the card sums in no fixed
order), as tests/test_torch_train_cuda.py holds the single-device step."""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (this worker's thread budget)

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.datasets import banded
from bsmr_sddmm_tpu_torch.formats import make_dense, random_mask
from bsmr_sddmm_tpu_torch.models import graph_transformer as gt
from bsmr_sddmm_tpu_torch.models import sparse_transformer as st
from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.ops.sddmm import (device_plan, make_sddmm_body,
                                            sddmm_ref)
from bsmr_sddmm_tpu_torch.pack import pack_tiles
from bsmr_sddmm_tpu_torch.parallel import (collectives, make_mesh,
                                           make_ring_sddmm,
                                           make_sharded_sddmm, ring_operands,
                                           shard_operands)
from bsmr_sddmm_tpu_torch.reorder import bsmr
from bsmr_sddmm_tpu_torch.utils.checkdata import check_data

TOL = dict(rtol=1e-5, atol=1e-4)
N = 4
SMALL = dict(rows=512, cols=768, nnz=20000, seed=7, block_rows=24,
             block_cols=96)
BASE = dict(k=128, panel_height=16, subpack_min_nnz=12, delta=0.05)
KERNELS = ("bsr_dense", "subpack", "dense_tile", "fused_gathered",
           "residual")


@pytest.fixture
def cuda():
    """The first CUDA device; skips the test where there is none (decided
    here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the GPU run python -m pytest "
                    "--noconftest -m cuda tests/test_torch_parallel_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def launches():
    return {name: getattr(dk, name).launches for name in KERNELS}


def since(before):
    return {name: n - before[name] for name, n in launches().items()}


def problem(**cfg_kw):
    csr = random_mask(**SMALL)
    cfg = SddmmConfig(**dict(BASE, **cfg_kw))
    A = make_dense(csr.rows, cfg.k, seed=1337)
    Bt = np.ascontiguousarray(make_dense(cfg.k, csr.cols, seed=1338).T)
    return csr, bsmr(csr, cfg), cfg, A, Bt


@pytest.mark.cuda
@pytest.mark.parametrize("b_sharded,gathered", [(False, "xla"), (True, "xla"),
                                                (False, "fused")])
def test_sharded_kernels_match_plain(cuda, b_sharded, gathered):
    csr, reord, cfg, A, Bt = problem(gathered_backend=gathered)
    mesh = make_mesh(devices=[cuda] * N)
    A_dev, Bt_dev = shard_operands(A, Bt, mesh, b_sharded=b_sharded)
    outs = {}
    for backend in ("auto", "torch"):
        fn, dplan, plans = make_sharded_sddmm(
            csr, reord, cfg, mesh, backend=backend, b_sharded=b_sharded,
            emit="csr")
        before = launches()
        collectives.zero_counts()
        outs[backend] = fn(A_dev, Bt_dev, dplan)
        torch.cuda.synchronize()
        counts, launched = collectives.read_counts(), since(before)
        assert counts["all_gather"] == int(b_sharded)
        if backend == "auto":
            # a tier kernel launches on every shard whose common tier
            # shape is not empty (pad tiles included)
            assert launched["bsr_dense"] == N * bool(
                plans[0].tile_panel.shape[0])
            assert launched["subpack"] == N * bool(
                plans[0].sp_panel.shape[0])
            assert launched["fused_gathered"] == N * (
                gathered == "fused" and plans[0].g_panel.shape[0] > 0
                and plans[0].g_groups is None)
            assert launched["residual"] == N * bool(
                plans[0].res_arow.shape[0])
        else:
            assert not any(launched.values())
    assert outs["auto"].device.type == "cuda"
    torch.testing.assert_close(outs["auto"], outs["torch"], **TOL)
    assert check_data(sddmm_ref(A, Bt.T, csr),
                      outs["auto"].cpu().numpy()).passed


@pytest.mark.cuda
def test_ring_kernels_match_plain(cuda):
    csr = banded(2048, 60000, 128, seed=3)
    cfg = SddmmConfig(k=128, panel_height=16, delta=0.02,
                      residual_tile_min_nnz=8)
    reord = bsmr(csr, cfg)
    A = make_dense(csr.rows, cfg.k, seed=1)
    Bt = make_dense(csr.cols, cfg.k, seed=2)
    mesh = make_mesh(devices=[cuda] * N)
    outs = {}
    for backend in ("auto", "torch"):
        fn, plan = make_ring_sddmm(csr, reord, cfg, mesh, backend=backend)
        before = launches()
        collectives.zero_counts()
        outs[backend] = fn(*ring_operands(A, Bt, plan, mesh))
        torch.cuda.synchronize()
        counts, launched = collectives.read_counts(), since(before)
        assert (counts["ring_shift"], counts["all_gather"]) == (N - 1, 0)
        if backend == "auto":
            assert launched["bsr_dense"] == N * N
            assert launched["dense_tile"] == N * N * bool(
                plan.tiles_g_per_group)
            assert launched["residual"] == N * N * bool(plan.res_per_group)
    torch.testing.assert_close(outs["auto"], outs["torch"], **TOL)
    assert check_data(sddmm_ref(A, Bt.T, csr),
                      outs["auto"].cpu().numpy()).passed


@pytest.mark.cuda
def test_csr_scatter_kernels_match_plain(cuda):
    csr, reord, cfg, A, Bt = problem()
    plan = pack_tiles(csr, reord, cfg)
    dp = device_plan(plan, cuda)
    At, Btt = torch.from_numpy(A).to(cuda), torch.from_numpy(Bt).to(cuda)
    got = make_sddmm_body(plan, cfg, emit="csr_scatter")(At, Btt, dp)
    plain = make_sddmm_body(plan, cfg, backend="torch",
                            emit="csr_scatter")(At, Btt, dp)
    csr_out = make_sddmm_body(plan, cfg, emit="csr")(At, Btt, dp)
    nnz = csr.nnz
    assert got.shape == (nnz + 1,)
    torch.testing.assert_close(got[:nnz], plain[:nnz], **TOL)
    torch.testing.assert_close(got[:nnz], csr_out, rtol=0, atol=0)


# the families at K=128 on a square mask (graph) and a local + strided mask
# (sequence): (module, model, mask, config, learning rate of the descent)
FAMILIES = {
    "graph": (gt, dict(num_nodes=512, feature_dim=16, head_dim=128,
                       num_heads=2, num_layers=2, num_classes=8),
              dict(rows=512, cols=512, nnz=20000, seed=7, block_rows=24,
                   block_cols=96), 1e-5),
    "sparse": (st, dict(seq_len=1024, vocab_size=64, head_dim=128,
                        num_heads=2, num_layers=1),
               dict(window=128, stride=64), 1e-3),
}


def family(kind, device, mesh=None, backend="auto"):
    mod, model_kw, mask_kw, _ = FAMILIES[kind]
    cfg = SddmmConfig(**dict(BASE, backend=backend))
    kw = dict(config=cfg, device=device, mesh=mesh)
    if kind == "graph":
        model = gt.GraphTransformer(**model_kw)
        net, dplan, plan = gt.make_forward(model, random_mask(**mask_kw),
                                           **kw)
        rng = np.random.default_rng(2)
        batch = (torch.from_numpy(rng.standard_normal(
            (model.num_nodes, model.feature_dim)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, model.num_classes,
                                          model.num_nodes)))
    else:
        model = st.SparseTransformer(**model_kw)
        net, dplan, plan = st.make_forward(model, **mask_kw, **kw)
        batch = (torch.from_numpy(np.random.default_rng(0).integers(
            0, model.vocab_size, model.seq_len)),)
    return mod, model, net, dplan, plan, tuple(b.to(device) for b in batch)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_sharded_train_step_kernels_match_plain(cuda, kind):
    """The 4-shard step through the hand kernels against the same step on
    the plain versions and against the single-device kernel step: logits
    and every gradient; bsr_dense and subpack launched once per shard,
    head and layer; three Adam steps lower the loss."""
    mesh = make_mesh(devices=[cuda] * N)
    mod, model, net, dplan, plans, batch = family(kind, cuda, mesh)
    runs = {"sharded": (net, dplan),
            "plain": family(kind, cuda, mesh, backend="torch")[2:4],
            "single": family(kind, cuda)[2:4]}
    logits = {}
    for name, (m, dp) in runs.items():
        before = launches()
        with torch.no_grad():
            logits[name] = m(batch[0], dp)
        mod.loss_fn(m, *batch, dp).backward()
        torch.cuda.synchronize()
        launched = since(before)
        if name == "sharded":
            per = N * model.num_heads * model.num_layers * 2  # 2 forwards
            assert launched["bsr_dense"] == per * bool(
                plans[0].tile_panel.shape[0])
            assert launched["subpack"] == per * bool(
                plans[0].sp_panel.shape[0])
            assert launched["residual"] == per * bool(
                plans[0].res_arow.shape[0])
            assert launched["bsr_dense"] and launched["subpack"]
        elif name == "plain":
            assert not any(launched.values())
    for name in ("plain", "single"):
        torch.testing.assert_close(logits["sharded"], logits[name],
                                   rtol=2e-4, atol=2e-4)
        for (pname, p), (_, q) in zip(net.named_parameters(),
                                      runs[name][0].named_parameters()):
            torch.testing.assert_close(
                p.grad, q.grad, rtol=1e-3,
                atol=1e-4 * float(q.grad.abs().max()), msg=pname)
    opt_init, step = mod.make_train_step(model, net, FAMILIES[kind][3])
    opt = opt_init()
    losses = [float(step(opt, *batch, dplan)) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[2] < losses[0]


@pytest.mark.cuda
def test_graft_entry_points_match_plain(cuda):
    """graft_entry.entry()'s forward and dryrun_multichip(8) on the tiny
    problem, the shards on the visible cards (cycled), through the hand
    kernels against the same built on the plain versions; the dry run holds
    every SDDMM output to the oracle itself."""
    from bsmr_sddmm_tpu_torch import graft_entry
    csr, cfg = graft_entry._tiny_problem()
    plain = (csr, cfg.replace(backend="torch"))
    before = launches()
    fn, args = graft_entry.entry()
    pfn, pargs = graft_entry.entry(problem=plain)
    with torch.no_grad():
        torch.testing.assert_close(fn(*args), pfn(*pargs), **TOL)
    got = graft_entry.dryrun_multichip(8)
    want = graft_entry.dryrun_multichip(8, problem=plain)
    launched = since(before)
    assert launched["bsr_dense"] and launched["subpack"]
    assert launched["dense_tile"]
    assert got["devices"][0] == "cuda:0" and len(got["devices"]) == 8
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    for key, vals in got["outputs"].items():
        np.testing.assert_allclose(vals, want["outputs"][key], **TOL,
                                   err_msg=key)
