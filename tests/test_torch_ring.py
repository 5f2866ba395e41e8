"""The port's B-panel ring against the JAX package's, on the cases of
tests/test_ring.py: ring plans bit for bit, each tier of the ring's output
against the JAX ring's on real slots (scatter index < nnz) at rtol 1e-5 /
atol 1e-5 (both fp32; the JAX ring's ``dot_general`` and the port's plain
kernel versions differ only in the order of summation), the CSR output
against the fp64 oracle with check_data (abs 1e-5 OR rel 1e-3), and the
collective counters in place of the jaxpr check (n - 1 ring hops, no
all-gather). Inputs are made with NumPy from fixed seeds and handed to
both packages; the port runs on a mesh of CPU devices."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (this worker's thread budget)

import bsmr_sddmm_tpu.datasets as jds
import bsmr_sddmm_tpu.formats as jfm
from bsmr_sddmm_tpu.config import SddmmConfig as JConfig
from bsmr_sddmm_tpu.parallel import ring as jring
from bsmr_sddmm_tpu.parallel.sharding import make_mesh as j_make_mesh
from bsmr_sddmm_tpu.reorder import bsmr as j_bsmr

import bsmr_sddmm_tpu_torch.datasets as tds
import bsmr_sddmm_tpu_torch.formats as tfm
from bsmr_sddmm_tpu_torch.config import SddmmConfig as TConfig
from bsmr_sddmm_tpu_torch.ops.sddmm import sddmm_ref
from bsmr_sddmm_tpu_torch.parallel import collectives
from bsmr_sddmm_tpu_torch.parallel import ring as tring
from bsmr_sddmm_tpu_torch.parallel.sharding import make_mesh
from bsmr_sddmm_tpu_torch.reorder import bsmr as t_bsmr
from bsmr_sddmm_tpu_torch.utils.checkdata import check_data

TOL = dict(rtol=1e-5, atol=1e-5)
RING_CFG = dict(k=32, panel_height=16, delta=0.02)


def hub_masks():
    """tests/test_ring.py::test_ring_gathered_tier_oracle's hub mask in
    both packages: many rows hit a small set of columns."""
    rng = np.random.default_rng(11)
    rows, cols = 768, 2048
    hub = rng.integers(0, 64, 22000)
    rr = rng.integers(0, rows, 22000)
    uniq = np.unique(rr * cols + hub)
    r_idx, c_idx = uniq // cols, uniq % cols
    order = np.lexsort((c_idx, r_idx))
    r_idx, c_idx = r_idx[order], c_idx[order]
    offs = np.zeros(rows + 1, np.int64)
    np.add.at(offs, r_idx + 1, 1)
    np.cumsum(offs, out=offs)
    kw = dict(rows=rows, cols=cols, row_offsets=offs,
              col_indices=c_idx.astype(np.int32),
              values=np.ones(r_idx.shape[0], np.float32))
    return jfm.CSR(**kw), tfm.CSR(**kw)


# name -> (masks, config, ring length): every case of tests/test_ring.py
RING_CASES = {
    "banded_2": (("banded", dict(n=1024, nnz=30000, bandwidth=96, seed=3)),
                 RING_CFG, 2),
    "banded_8": (("banded", dict(n=1024, nnz=30000, bandwidth=96, seed=3)),
                 RING_CFG, 8),
    "blocks_2": (("random_mask", dict(rows=768, cols=1500, nnz=25000, seed=9,
                                      block_rows=24, block_cols=96)),
                 RING_CFG, 2),
    "blocks_8": (("random_mask", dict(rows=768, cols=1500, nnz=25000, seed=9,
                                      block_rows=24, block_cols=96)),
                 RING_CFG, 8),
    "partition_4": (("random_mask", dict(rows=512, cols=1024, nnz=20000,
                                         seed=5, block_rows=16,
                                         block_cols=64)),
                    dict(k=32, panel_height=16, delta=0.05), 4),
    "hub_4": ("hub", dict(k=32, panel_height=16, delta=0.6,
                          residual_tile_min_nnz=8), 4),
    "hops_4": (("banded", dict(n=512, nnz=12000, bandwidth=64, seed=7)),
               RING_CFG, 4),
}


def ring_case(case):
    src, cfg_kw, n = RING_CASES[case]
    if src == "hub":
        jcsr, tcsr = hub_masks()
    else:
        gen, kw = src
        jsrc, tsrc = (jfm, tfm) if gen == "random_mask" else (jds, tds)
        jcsr, tcsr = getattr(jsrc, gen)(**kw), getattr(tsrc, gen)(**kw)
    np.testing.assert_array_equal(jcsr.col_indices, tcsr.col_indices)
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    return (jcsr, j_bsmr(jcsr, jcfg), jcfg), \
        (tcsr, t_bsmr(tcsr, tcfg), tcfg), n


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_plan_bit_identical(case):
    (jcsr, jre, jcfg), (tcsr, tre, tcfg), n = ring_case(case)
    want = jring.pack_ring_plans(jcsr, jre, jcfg, n)
    got = tring.pack_ring_plans(tcsr, tre, tcfg, n)
    for f in dataclasses.fields(got):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, (f.name, a, b)
    if case == "hub_4":
        assert got.num_gathered > 0


def test_ring_packing_partition():
    """Every nonzero lands in exactly one (shard, panel) group slot across
    the dense + gathered + residual tiers; columns are panel-local."""
    _, (tcsr, tre, tcfg), n = ring_case("partition_4")
    plan = tring.pack_ring_plans(tcsr, tre, tcfg, n)
    nnz = tcsr.nnz
    allv = np.concatenate([plan.tile_scatter[plan.tile_scatter < nnz],
                           plan.g_scatter[plan.g_scatter < nnz],
                           plan.res_out[plan.res_out < nnz]])
    np.testing.assert_array_equal(np.sort(allv), np.arange(nnz))
    assert plan.tile_cb.max() < plan.w // plan.block_width
    if plan.num_gathered:
        assert plan.g_cols_l.max() < plan.w
    assert plan.res_col.max() < plan.w


RUN_CASES = ["banded_2", "banded_8", "blocks_2", "blocks_8", "hub_4",
             "hops_4"]


@pytest.mark.parametrize("case", RUN_CASES)
def test_ring_matches_reference_tier_by_tier(case):
    (jcsr, jre, jcfg), (tcsr, tre, tcfg), n = ring_case(case)
    A = tfm.make_dense(tcsr.rows, tcfg.k, seed=1)
    Bt = tfm.make_dense(tcsr.cols, tcfg.k, seed=2)
    jmesh = j_make_mesh(n)
    jfn, jplan = jring.make_ring_sddmm(jcsr, jre, jcfg, jmesh, emit="rphm")
    ref = [np.asarray(t) for t in jax.block_until_ready(
        jfn(*jring.ring_operands(A, Bt, jplan, jmesh)))]

    mesh = make_mesh(devices=["cpu"] * n)
    fn, plan = tring.make_ring_sddmm(tcsr, tre, tcfg, mesh, emit="rphm")
    A_dev, Bt_dev = tring.ring_operands(A, Bt, plan, mesh)
    assert len(Bt_dev) == n and Bt_dev[0].shape == (plan.w, tcfg.k)
    collectives.zero_counts()
    got = fn(A_dev, Bt_dev)
    counts = collectives.read_counts()
    assert counts == dict(all_gather=0, ring_shift=n - 1, csr_gather=0,
                          shard_hops=n * (n - 1), to_shards=0, from_shards=0,
                          all_reduce=0, cross_process_bytes=0)
    Tg = plan.tiles_g_per_group
    nnz = tcsr.nnz
    for name, r, g, sc in (
            ("dense", ref[0], got[0], plan.tile_scatter),
            ("gathered", ref[1], got[1], plan.g_scatter),
            ("residual", ref[2], got[2], plan.res_out)):
        g = torch.cat(g).numpy()
        real = sc.reshape((n * n,) + sc.shape[2:]) < nnz
        if name == "gathered" and not Tg:
            assert g.shape == (n * n, 0, plan.panel_height,
                               plan.block_width)
            continue
        r = r.reshape(g.shape)
        np.testing.assert_allclose(g[real], r[real], err_msg=name, **TOL)
    if case == "hub_4":
        assert Tg > 0


@pytest.mark.parametrize("case", RUN_CASES)
def test_ring_csr_matches_oracle(case):
    _, (tcsr, tre, tcfg), n = ring_case(case)
    A = tfm.make_dense(tcsr.rows, tcfg.k, seed=1)
    Bt = tfm.make_dense(tcsr.cols, tcfg.k, seed=2)
    mesh = make_mesh(devices=["cpu"] * n)
    fn, plan = tring.make_ring_sddmm(tcsr, tre, tcfg, mesh, emit="csr")
    collectives.zero_counts()
    out = fn(*tring.ring_operands(A, Bt, plan, mesh))
    counts = collectives.read_counts()
    assert (counts["ring_shift"], counts["all_gather"],
            counts["csr_gather"]) == (n - 1, 0, 1)
    res = check_data(sddmm_ref(A, Bt.T, tcsr), out.numpy())
    assert res.passed, f"error rate {res.error_rate}"


@pytest.mark.parametrize("case", ["banded_2", "hub_4"])
def test_ring_at_default_precision_matches_reference(case):
    """matmul_precision="default": the port's ring (one TF32 pass in its
    tile kernels' plain versions) against the JAX ring at the same setting
    and the fp64 oracle, at the check_data tolerance; not the three-pass
    output."""
    (jcsr, jre, jcfg), (tcsr, tre, tcfg), n = ring_case(case)
    jcfg = JConfig(**dict(RING_CASES[case][1], matmul_precision="default"))
    tcfg = tcfg.replace(matmul_precision="default")
    A = tfm.make_dense(tcsr.rows, tcfg.k, seed=1)
    Bt = tfm.make_dense(tcsr.cols, tcfg.k, seed=2)
    jmesh = j_make_mesh(n)
    jfn, jplan = jring.make_ring_sddmm(jcsr, jre, jcfg, jmesh)
    ref = np.asarray(jfn(*jring.ring_operands(A, Bt, jplan, jmesh)))
    mesh = make_mesh(devices=["cpu"] * n)
    outs = {}
    for cfg in (tcfg, tcfg.replace(matmul_precision="bf16x3")):
        fn, plan = tring.make_ring_sddmm(tcsr, tre, cfg, mesh)
        outs[cfg.matmul_precision] = fn(
            *tring.ring_operands(A, Bt, plan, mesh)).numpy()
    got = outs["default"]
    assert check_data(ref, got).passed
    assert check_data(sddmm_ref(A, Bt.T, tcsr), got).passed
    assert not np.array_equal(got, outs["bf16x3"])


def test_ring_plain_backend_equals_auto_on_cpu():
    """backend="torch" runs the plain versions everywhere; on CPU tensors
    "auto" runs them too, so both give the same values."""
    _, (tcsr, tre, tcfg), n = ring_case("hub_4")
    A = tfm.make_dense(tcsr.rows, tcfg.k, seed=1)
    Bt = tfm.make_dense(tcsr.cols, tcfg.k, seed=2)
    mesh = make_mesh(devices=["cpu"] * n)
    outs = []
    for backend in ("auto", "torch"):
        fn, plan = tring.make_ring_sddmm(tcsr, tre, tcfg, mesh,
                                         backend=backend)
        outs.append(fn(*tring.ring_operands(A, Bt, plan, mesh)))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="backend"):
        tring.make_ring_sddmm(tcsr, tre, tcfg, mesh, backend="xla")
