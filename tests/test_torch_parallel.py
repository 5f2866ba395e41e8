"""The port's parallel layer against the JAX package's: shard plans, cost
weights, the sharded CSR map, the data-parallel plan split, the scaling
model, ``emit="csr_scatter"`` and the sharded SDDMM tier by tier, on the
inputs of the JAX package's own tests (tests/test_parallel_extras.py,
tests/test_ring.py, tests/test_harness.py), made with NumPy from fixed
seeds and handed to both packages.

The port runs on a mesh of CPU devices (``make_mesh(devices=["cpu"] *
n)``), where the body runs the plain versions of its kernels; the JAX
package runs on its 8 virtual CPU devices (tests/conftest.py). Plans and
maps are compared bit for bit; the scaling model's floats within 1e-12
(relative; the same NumPy arithmetic on the same plans); outputs tier by
tier on real slots (scatter index < nnz) at rtol 1e-5 / atol 1e-5 (both
sides fp32, only the order of summation differs), and against the fp64
oracle with check_data (abs 1e-5 OR rel 1e-3). The collective counters of
``parallel.collectives`` stand in for the JAX tests' jaxpr inspection.
The ring is tested in tests/test_torch_ring.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsmr_sddmm_tpu.datasets as jds
import bsmr_sddmm_tpu.formats as jfm
import bsmr_sddmm_tpu.ops.sddmm as jops
import bsmr_sddmm_tpu.pack as jpack
import bsmr_sddmm_tpu.parallel as jpar
from bsmr_sddmm_tpu.config import SddmmConfig as JConfig
from bsmr_sddmm_tpu.parallel import scaling_model as jscale
from bsmr_sddmm_tpu.reorder import bsmr as j_bsmr

import bsmr_sddmm_tpu_torch.datasets as tds
import bsmr_sddmm_tpu_torch.formats as tfm
import bsmr_sddmm_tpu_torch.pack as tpack
import bsmr_sddmm_tpu_torch.parallel as tpar
from bsmr_sddmm_tpu_torch.config import SddmmConfig as TConfig
from bsmr_sddmm_tpu_torch.interop import (config_from_reference,
                                          plan_from_reference)
from bsmr_sddmm_tpu_torch.ops.sddmm import (device_plan, make_sddmm_body,
                                            sddmm_ref)
from bsmr_sddmm_tpu_torch.parallel import collectives
from bsmr_sddmm_tpu_torch.parallel import distributed as tdist
from bsmr_sddmm_tpu_torch.parallel import scaling_model as tscale
from bsmr_sddmm_tpu_torch.reorder import bsmr as t_bsmr
from bsmr_sddmm_tpu_torch.utils.checkdata import check_data

TOL = dict(rtol=1e-5, atol=1e-5)
BASE = dict(k=32, panel_height=16, dense_chunk=16, residual_chunk=2048)
# (generator, its arguments, config, mesh size): the cases of
# tests/test_parallel_extras.py:41-152 and :183-204
SHARD_CASES = {
    "blocks": ("random_mask", dict(rows=256, cols=512, nnz=6000, seed=13,
                                   block_rows=16, block_cols=64), BASE, 8),
    "windowed": ("random_mask", dict(rows=1024, cols=32768, nnz=40000,
                                     seed=29, block_rows=16, block_cols=64),
                 dict(BASE, gather_window_mb=1, gather_window_threshold_mb=1,
                      residual_tile_min_nnz=4), 8),
    "a_windowed": ("random_mask", dict(rows=16384, cols=4096, nnz=60000,
                                       seed=31, block_rows=16,
                                       block_cols=64),
                   dict(BASE, k=128, gather_window_mb=1,
                        gather_window_threshold_mb=1), 2),
    "rmat": ("rmat", dict(n=4096, nnz=150000, seed=13),
             dict(k=128, panel_height=32, delta=0.006), 4),
}
TIERS = ("dense", "packed", "gathered", "residual")


def both_masks(gen, kw):
    """The same mask from both packages' generators (bit-identical, as
    tests/test_torch_host.py holds)."""
    jsrc = jfm if gen == "random_mask" else jds
    tsrc = tfm if gen == "random_mask" else tds
    jcsr, tcsr = getattr(jsrc, gen)(**kw), getattr(tsrc, gen)(**kw)
    np.testing.assert_array_equal(jcsr.col_indices, tcsr.col_indices)
    return jcsr, tcsr


def both_cases(case):
    gen, kw, cfg_kw, n = SHARD_CASES[case]
    jcsr, tcsr = both_masks(gen, kw)
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    return (jcsr, j_bsmr(jcsr, jcfg), jcfg), \
        (tcsr, t_bsmr(tcsr, tcfg), tcfg), n


def assert_same_fields(ref, port, skip=("pack_time_ms",)):
    """Every dataclass field of ``port`` equals ``ref``'s: arrays bit for
    bit with the same dtype, everything else with ==."""
    for f in dataclasses.fields(port):
        if f.name in skip:
            continue
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, (f.name, a, b)


def cpu_mesh(n):
    return tpar.make_mesh(devices=["cpu"] * n)


def operands(csr, k):
    A = tfm.make_dense(csr.rows, k, seed=1337)
    Bt = np.ascontiguousarray(tfm.make_dense(k, csr.cols, seed=1338).T)
    return A, Bt


# ---------------------------------------------------------------------------
# shard packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("balance", ["cost", "nnz"])
@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_shard_plans_bit_identical(case, balance):
    (jcsr, jre, jcfg), (tcsr, tre, tcfg), n = both_cases(case)
    jplans = jpack.pack_shard_plans(jcsr, jre, jcfg, n, balance=balance)
    tplans = tpack.pack_shard_plans(tcsr, tre, tcfg, n, balance=balance)
    assert len(tplans) == n
    for jp, tp in zip(jplans, tplans):
        assert_same_fields(jp, tp)
    np.testing.assert_array_equal(jpar.sharded_rphm_to_csr(jplans),
                                  tpar.sharded_rphm_to_csr(tplans))
    if case == "windowed":
        assert tplans[0].g_groups and len(tplans[0].g_groups) > 1
        assert tplans[0].res_groups and len(tplans[0].res_groups) > 1
    if case == "a_windowed":
        assert tplans[0].a_window_rows is not None
    if case == "rmat":
        assert tplans[0].fat_group > 1


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_panel_cost_weights_equal(case):
    (jcsr, jre, jcfg), (tcsr, tre, tcfg), _ = both_cases(case)
    want = jpack.panel_cost_weights(jcsr, jre, jcfg)
    got = tpack.panel_cost_weights(tcsr, tre, tcfg)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_pack_tiles_fat_group_override():
    (jcsr, jre, jcfg), (tcsr, tre, tcfg), _ = both_cases("rmat")
    for G in (1, 4):
        assert_same_fields(
            jpack.pack_tiles(jcsr, jre, jcfg, fat_group_override=G),
            tpack.pack_tiles(tcsr, tre, tcfg, fat_group_override=G))


def test_shard_device_plan_matches_reference():
    """The data-parallel split of one global plan: shard j's arrays equal
    the JAX package's shard j of the same array; maps replicated."""
    (jcsr, jre, jcfg), _, n = both_cases("blocks")
    jplan = jpack.pack_tiles(jcsr, jre, jcfg)
    jd = jpar.shard_device_plan(jplan, jpar.make_mesh(n))
    td = tpar.shard_device_plan(plan_from_reference(jplan), cpu_mesh(n))
    assert len(td) == n
    for name in jd._fields:
        arr = getattr(jd, name)
        shards = sorted(arr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        replicated = name in ("row_perm_padded", "sp_colperm", "rphm_to_csr")
        for j, dp in enumerate(td):
            want = np.asarray(arr) if replicated else np.asarray(
                shards[j].data)
            np.testing.assert_array_equal(getattr(dp, name).numpy(), want,
                                          err_msg=name)


# ---------------------------------------------------------------------------
# the sharded SDDMM
# ---------------------------------------------------------------------------

def jax_sharded_tiers(jcsr, jre, jcfg, n, A, Bt, b_sharded):
    mesh = jpar.make_mesh(n)
    fn, dplan, plans = jpar.make_sharded_sddmm(
        jcsr, jre, jcfg, mesh, b_sharded=b_sharded, emit="rphm")
    A_dev, Bt_dev = jpar.shard_operands(A, Bt, mesh, b_sharded=b_sharded)
    return [np.asarray(t) for t in fn(A_dev, Bt_dev, dplan)], plans


SHARDED_RUNS = [("blocks", False), ("blocks", True), ("windowed", False),
                ("a_windowed", False)]


@pytest.mark.parametrize("case,b_sharded", SHARDED_RUNS)
def test_sharded_sddmm_matches_reference_tier_by_tier(case, b_sharded):
    (jcsr, jre, jcfg), (tcsr, tre, tcfg), n = both_cases(case)
    A, Bt = operands(tcsr, tcfg.k)
    ref, jplans = jax_sharded_tiers(jcsr, jre, jcfg, n, A, Bt, b_sharded)
    mesh = cpu_mesh(n)
    fn, dplan, plans = tpar.make_sharded_sddmm(
        tcsr, tre, tcfg, mesh, b_sharded=b_sharded, emit="rphm")
    for jp, tp in zip(jplans, plans):
        assert_same_fields(jp, tp)
    A_dev, Bt_dev = tpar.shard_operands(A, Bt, mesh, b_sharded=b_sharded)
    collectives.zero_counts()
    got = fn(A_dev, Bt_dev, dplan)
    counts = collectives.read_counts()
    # the hot path: no collective with B replicated, one gather of B with
    # B sharded (the JAX tests read the same from the jaxpr)
    assert counts == dict(all_gather=int(b_sharded), ring_shift=0,
                          csr_gather=0, shard_hops=0, to_shards=0,
                          from_shards=0, all_reduce=0, cross_process_bytes=0)
    nnz = tcsr.nnz
    scatters = [np.concatenate([getattr(p, name) for p in plans])
                for name in ("tile_scatter", "sp_scatter", "g_scatter",
                             "res_out")]
    for tier, r, g, sc in zip(TIERS, ref, got, scatters):
        g = torch.cat(g).numpy()
        assert g.shape == r.shape, tier
        real = sc < nnz
        np.testing.assert_allclose(g[real], r[real], err_msg=tier, **TOL)
    big = np.concatenate([torch.cat(t).reshape(-1).numpy() for t in got])
    out = big[tpar.sharded_rphm_to_csr(plans)]
    assert check_data(sddmm_ref(A, Bt.T, tcsr), out).passed


@pytest.mark.parametrize("case,b_sharded", SHARDED_RUNS)
def test_sharded_csr_matches_oracle(case, b_sharded):
    _, (tcsr, tre, tcfg), n = both_cases(case)
    A, Bt = operands(tcsr, tcfg.k)
    mesh = cpu_mesh(n)
    fn, dplan, plans = tpar.make_sharded_sddmm(
        tcsr, tre, tcfg, mesh, b_sharded=b_sharded, emit="csr")
    assert len(plans) == n and len(dplan) == n
    A_dev, Bt_dev = tpar.shard_operands(A, Bt, mesh, b_sharded=b_sharded)
    collectives.zero_counts()
    out = fn(A_dev, Bt_dev, dplan)
    assert collectives.read_counts()["csr_gather"] == 1
    assert out.shape == (tcsr.nnz,)
    assert check_data(sddmm_ref(A, Bt.T, tcsr), out.numpy()).passed
    # every shard shares the first shard's shapes and static window
    # metadata (one body serves them all)
    for p in plans[1:]:
        for name in ("g_groups", "res_groups", "window_rows",
                     "a_window_rows", "fat_group", "num_panels"):
            assert getattr(p, name) == getattr(plans[0], name), name
        for name in ("tile_panel", "sp_panel", "sp_colperm", "g_panel",
                     "res_arow"):
            assert getattr(p, name).shape == getattr(plans[0], name).shape


@pytest.mark.parametrize("precision,serialize", [("default", "off"),
                                                  ("bf16x3", "on")])
def test_sharded_sddmm_reads_both_settings(precision, serialize,
                                           monkeypatch):
    """The sharded body is make_sddmm_body of the config it is given, so
    it takes matmul_precision and tier_serialize as the single-device body
    does: tier by tier against the JAX sharded SDDMM at that precision, at
    the check_data tolerance."""
    from bsmr_sddmm_tpu_torch.parallel import sharding
    (jcsr, jre, jcfg), (tcsr, tre, tcfg), n = both_cases("blocks")
    jcfg = JConfig(**dict(SHARD_CASES["blocks"][2],
                          matmul_precision=precision))
    tcfg = tcfg.replace(matmul_precision=precision, tier_serialize=serialize)
    A, Bt = operands(tcsr, tcfg.k)
    ref, _ = jax_sharded_tiers(jcsr, jre, jcfg, n, A, Bt, False)
    built = []
    monkeypatch.setattr(sharding, "make_sddmm_body",
                        lambda plan, cfg, *a, **kw: built.append(cfg)
                        or make_sddmm_body(plan, cfg, *a, **kw))
    mesh = cpu_mesh(n)
    fn, dplan, plans = tpar.make_sharded_sddmm(tcsr, tre, tcfg, mesh,
                                               emit="rphm")
    assert built == [tcfg]
    got = fn(*tpar.shard_operands(A, Bt, mesh), dplan)
    nnz = tcsr.nnz
    for tier, r, g, name in zip(TIERS, ref, got, (
            "tile_scatter", "sp_scatter", "g_scatter", "res_out")):
        real = np.concatenate([getattr(p, name) for p in plans]) < nnz
        res = check_data(r[real], torch.cat(g).numpy()[real])
        assert res.passed, f"{tier}: {res}"


def test_sharded_shard_operands_divisibility():
    mesh = cpu_mesh(8)
    A = np.zeros((16, 8), np.float32)
    Bt = np.zeros((30, 8), np.float32)  # 30 % 8 != 0
    with pytest.raises(ValueError, match="divisible"):
        tpar.shard_operands(A, Bt, mesh, b_sharded=True)


def test_sharded_unknown_emit_raises():
    _, (tcsr, tre, tcfg), _ = both_cases("blocks")
    with pytest.raises(ValueError, match="emit"):
        tpar.make_sharded_sddmm(tcsr, tre, tcfg, cpu_mesh(2),
                                emit="csr_scatter")


def test_make_mesh_raises_rather_than_truncate(monkeypatch):
    """Asked for more cards than are visible, make_mesh raises (the JAX
    version truncates); without a card it raises unless given devices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tpar.make_mesh(1).devices == (torch.device("cuda:0"),)
    with pytest.raises(ValueError, match="2 devices asked for"):
        tpar.make_mesh(2)
    with pytest.raises(ValueError, match="3 devices asked for"):
        tpar.make_mesh(3, devices=["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh()
    mesh = tpar.make_mesh(2, devices=["cpu"] * 4)
    assert (mesh.size, mesh.world_size, list(mesh.owned)) == (2, 1, [0, 1])
    assert mesh.axis_names == (tpar.sharding.AXIS,) == ("panels",)


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    tdist.initialize()
    tdist.initialize(num_processes=1)
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# emit="csr_scatter"
# ---------------------------------------------------------------------------

SMALL = dict(rows=512, cols=768, nnz=20000, seed=7, block_rows=24,
             block_cols=96)
WIDE = dict(rows=1024, cols=40960, nnz=80000, seed=31, block_rows=16,
            block_cols=64)
BODY = dict(k=32, panel_height=16, block_width=128, dense_chunk=64,
            residual_chunk=4096)
SCATTER_CASES = {
    "default": (SMALL, BODY),
    "fat_group_1": (SMALL, dict(BODY, dense_fat_group=1)),
    "subpack_0": (SMALL, dict(BODY, subpack_min_nnz=0)),
    "windowed": (WIDE, dict(k=32, panel_height=16, dense_chunk=16,
                            residual_chunk=2048, delta=0.9,
                            gather_window_mb=1, gather_window_threshold_mb=2)),
    "reorder": (SMALL, dict(BODY, col_mode="reorder")),
    "fp16": (SMALL, dict(BODY, out_dtype="float16")),
}


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_csr_scatter_matches_reference(case):
    """[:nnz] of the port's csr_scatter against the JAX body's
    (backend="xla") at rtol 1e-5 / atol 1e-5 (fp16 output at the
    check_data tolerance: each side rounds once), and against its own
    csr emission; the trash slot is the last of nnz + 1."""
    spec, cfg_kw = SCATTER_CASES[case]
    jcfg = JConfig(**cfg_kw)
    jcsr = jfm.random_mask(**spec)
    jplan = jpack.pack_tiles(jcsr, j_bsmr(jcsr, jcfg), jcfg)
    tplan, tcfg = plan_from_reference(jplan), config_from_reference(jcfg)
    A, Bt = operands(jcsr, jcfg.k)
    ref = np.asarray(jops.make_sddmm_body(jplan, jcfg, backend="xla",
                                          emit="csr_scatter")(
        jnp.asarray(A), jnp.asarray(Bt), jops.device_plan(jplan)))
    dp = device_plan(tplan, "cpu")
    At, Btt = torch.from_numpy(A), torch.from_numpy(Bt)
    got = make_sddmm_body(tplan, tcfg, emit="csr_scatter")(At, Btt, dp)
    csr = make_sddmm_body(tplan, tcfg, emit="csr")(At, Btt, dp)
    nnz = jcsr.nnz
    assert got.shape == (nnz + 1,) and got.dtype == csr.dtype
    if case == "fp16":
        assert check_data(ref[:nnz].astype(np.float32),
                          got[:nnz].float().numpy()).passed
    else:
        np.testing.assert_allclose(got[:nnz].numpy(), ref[:nnz], **TOL)
    torch.testing.assert_close(got[:nnz], csr, rtol=0, atol=0)
    if case == "subpack_0":
        assert tplan.sp_panel.shape[0] == 0
    if case == "windowed":
        assert tplan.g_groups or tplan.res_groups


def test_csr_scatter_needs_the_scatter_maps():
    spec, cfg_kw = SCATTER_CASES["default"]
    tcsr = tfm.random_mask(**spec)
    tcfg = TConfig(**cfg_kw)
    tplan = tpack.pack_tiles(tcsr, t_bsmr(tcsr, tcfg), tcfg)
    A, Bt = operands(tcsr, tcfg.k)
    body = make_sddmm_body(tplan, tcfg, emit="csr_scatter")
    with pytest.raises(ValueError, match="scatter maps"):
        body(torch.from_numpy(A), torch.from_numpy(Bt),
             device_plan(tplan, "cpu", emit="rphm"))


# ---------------------------------------------------------------------------
# the scaling model
# ---------------------------------------------------------------------------

def assert_prediction_equal(want, got):
    assert got.n == want.n and got.k == want.k
    assert got.hop_bytes == want.hop_bytes
    np.testing.assert_allclose(got.shard_ms, want.shard_ms, rtol=1e-12)
    for name in ("imbalance", "comm_ms", "efficiency_overlapped",
                 "efficiency_blocking"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-12, err_msg=name)


def scaling_case(gen, kw, cfg_kw):
    jcsr, tcsr = both_masks(gen, kw)
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    return (jcsr, j_bsmr(jcsr, jcfg), jcfg), (tcsr, t_bsmr(tcsr, tcfg), tcfg)


def test_predict_weak_scaling_equal():
    """tests/test_ring.py::test_scaling_model_predictions' mask: the same
    predictions, within 1e-12, at n = 2, 4, 8."""
    (jc, jr, jcfg), (tc, tr, tcfg) = scaling_case(
        "banded", dict(n=4096, nnz=120000, bandwidth=96, seed=3),
        dict(k=128, panel_height=32, delta=0.006))
    for n in (2, 4, 8):
        want = jscale.predict_weak_scaling(jc, jr, jcfg, n)
        got = tscale.predict_weak_scaling(tc, tr, tcfg, n)
        assert_prediction_equal(want, got)
        assert got.to_dict() == want.to_dict()
    assert got.efficiency_overlapped >= 0.8


@pytest.mark.parametrize("case", ["banded", "rmat_free_ici", "rmat_nosub"])
def test_choose_layout_equal(case):
    """tests/test_ring.py::test_choose_layout_is_the_cost_models_call's
    masks: the same layout and step times within 1e-12."""
    cfg_kw = dict(k=128, panel_height=32, delta=0.006, subpack_min_nnz=12)
    ici = {}
    if case == "banded":
        gen, kw = "banded", dict(n=8192, nnz=500000, bandwidth=96, seed=3)
    else:
        gen, kw = "rmat", dict(n=14, nnz=200000, seed=5)
        if case == "rmat_free_ici":
            ici = dict(ici_gbps=1e9)
        else:
            cfg_kw["subpack_min_nnz"] = 0
    (jc, jr, jcfg), (tc, tr, tcfg) = scaling_case(gen, kw, cfg_kw)
    want = jscale.choose_layout(jc, jr, jcfg, 4, **ici)
    got = tscale.choose_layout(tc, tr, tcfg, 4, **ici)
    assert got.layout == want.layout
    np.testing.assert_allclose([got.t_ring_ms, got.t_allgather_ms],
                               [want.t_ring_ms, want.t_allgather_ms],
                               rtol=1e-12)
    assert_prediction_equal(want.prediction_ring, got.prediction_ring)
    assert_prediction_equal(want.prediction_allgather,
                            got.prediction_allgather)
    if case != "rmat_free_ici":
        assert got.layout == "ring"


def test_predict_suite_equal():
    cfg_kw = dict(k=128, panel_height=32, delta=0.006)
    gens = [("banded", dict(n=2048, nnz=60000, bandwidth=64, seed=3))]
    want = jscale.predict_suite(
        [(g, lambda g=g, kw=kw: getattr(jds, g)(**kw)) for g, kw in gens],
        JConfig(**cfg_kw), ns=(2, 4))
    got = tscale.predict_suite(
        [(g, lambda g=g, kw=kw: getattr(tds, g)(**kw)) for g, kw in gens],
        TConfig(**cfg_kw), ns=(2, 4))
    assert got == want


# ---------------------------------------------------------------------------
# weak scaling
# ---------------------------------------------------------------------------

def test_weak_scaling_structure():
    """tests/test_harness.py::test_weak_scaling_real_sddmm on the port: (a)
    per-shard plan shapes stay constant as the mesh grows with constant
    per-shard work, and (b) the replicated-B hot path runs no collective
    (the counters in place of the jaxpr)."""
    cfg = TConfig(k=32, panel_height=16, dense_chunk=16,
                  residual_chunk=2048)
    rows_per, cols = 256, 512
    piece = tdist._crop_cols(tds.banded(rows_per, 4000, 64, seed=7), cols)
    p_rows, p_cols = piece.coo_rows(), piece.col_indices
    shard_shapes = {}
    for n in (1, 2, 4):
        rr = np.concatenate([p_rows + i * rows_per for i in range(n)])
        cc = np.tile(p_cols, n)
        csr = tfm.COO(n * rows_per, cols, rr.astype(np.int32),
                      cc.astype(np.int32),
                      np.ones(rr.size, np.float32)).to_csr()
        mesh = cpu_mesh(n)
        fn, dplan, plans = tpar.make_sharded_sddmm(
            csr, t_bsmr(csr, cfg), cfg, mesh, k=32, emit="rphm")
        assert len(plans) == n
        shapes = {(p.tile_panel.shape, p.g_panel.shape, p.res_arow.shape,
                   p.num_panels) for p in plans}
        assert len(shapes) == 1, f"shards differ in shape: {shapes}"
        shard_shapes[n] = shapes.pop()
        A = tfm.make_dense(csr.rows, 32, seed=1)
        Bt = tfm.make_dense(csr.cols, 32, seed=2)
        A_dev, Bt_dev = tpar.shard_operands(A, Bt, mesh)
        collectives.zero_counts()
        d, pk, g, r = fn(A_dev, Bt_dev, dplan)
        assert not any(collectives.read_counts().values())
        assert all(np.isfinite(t.numpy()).all() for t in d)
    base = shard_shapes[1]
    for n in (2, 4):
        for got, want in zip(shard_shapes[n][:3], base[:3]):
            assert got[0] <= 2 * want[0], (n, got, want)


def shard_slots(shape, ph=16, bw=128):
    """Output slots of one shard plan: its tile tiers' (T + Tp + Tg) tiles
    of ph x bw and its E residual slots."""
    T, Tp, Tg, E, _ = shape
    return (T + Tp + Tg) * ph * bw + E


def test_sddmm_weak_scaling_on_cpu_mesh():
    """sddmm_weak_scaling at a small size on a pool of CPU devices: every
    count timed on the host clock, rates positive, efficiency 1 at the
    first count, the shards of a count sharing one shape, and each
    shard's output slots within one bucket step (2x) of the first
    count's. (The dense tile count alone grows with n: cropping the
    columns narrows the band.)"""
    res = tdist.sddmm_weak_scaling(
        [1, 2], rows_per_device=256, nnz_per_device=4000, cols=512, k=32,
        bandwidth=64, config=TConfig(k=32, panel_height=16),
        iterations=1, devices=["cpu"] * 2)
    assert sorted(res) == [1, 2]
    assert res[1]["efficiency"] == pytest.approx(1.0)
    for n, rec in res.items():
        assert rec["ms"] > 0 and rec["nnz_per_s"] > 0
        assert len(rec["shard_shapes"]) == n
        assert len(set(rec["shard_shapes"])) == 1
    base = shard_slots(res[1]["shard_shapes"][0])
    assert shard_slots(res[2]["shard_shapes"][0]) <= 2 * base
