"""The port's arm selection against the JAX package's: cost tables, plan
estimates, the delta/config choice (with and without measured refinement),
the calibration fit and its cache, the baselines and the dense fallback.

The same masks and operands (NumPy, fixed seeds) go to both packages. The
host half of ``autotune`` is a copy, so estimates, candidate tables and
picks must be exactly equal (``==`` on floats) on bit-identical plans.
Values are compared at rtol 1e-5 (both sides fp32; only the order of
summation differs). On the CPU the JAX refinement keeps the estimate order,
and so does the port's on a CPU device; the measured refinement and the
fallback on the card are tested in tests/test_torch_kernels.py (marker
``cuda``), which imports no JAX."""

import os

import numpy as np
import pytest
import torch

import bsmr_sddmm_tpu.autotune as jat
import bsmr_sddmm_tpu.baselines as jbase
from bsmr_sddmm_tpu.config import SddmmConfig as JConfig
from bsmr_sddmm_tpu.datasets import uniform as j_uniform
from bsmr_sddmm_tpu.formats import random_mask as j_random_mask
from bsmr_sddmm_tpu.sddmm import BsmrSddmm as JBsmrSddmm

import bsmr_sddmm_tpu_torch as bt
import bsmr_sddmm_tpu_torch.autotune as tat
import bsmr_sddmm_tpu_torch.baselines as tbase
from bsmr_sddmm_tpu_torch import cli
from bsmr_sddmm_tpu_torch.config import SddmmConfig as TConfig
from bsmr_sddmm_tpu_torch.datasets import uniform
from bsmr_sddmm_tpu_torch.formats import random_mask, save_mtx
from bsmr_sddmm_tpu_torch.ops.sddmm import sddmm_ref
from bsmr_sddmm_tpu_torch.utils.checkdata import check_data
from bsmr_sddmm_tpu_torch.utils.logger import parse_log_text
from test_torch_host import (BASE_CFG, SMALL, TINY, WIDE, WIDE_CFG,
                             assert_same, both_plans)

# sparse enough (M*N >> nnz) that a tiled plan beats the dense arm, with
# shuffled rows so that the three alphas cluster differently
AUTO = dict(rows=4096, cols=8192, nnz=30000, seed=23, block_rows=32,
            block_cols=128, block_fill=0.8, shuffle_rows=True)
AUTO_CFG = dict(k=32, panel_height=16, subpack_min_nnz=12, num_iterations=2)
# small and dense: the fallback wins (tests/test_harness.py:532)
DENSE = dict(rows=1024, cols=1024, nnz=150_000, seed=4)


@pytest.fixture(autouse=True)
def v5e_costs(monkeypatch):
    """Both packages price with V5E_COSTS: no calibration of another test
    leaks in, and none made here leaks out."""
    monkeypatch.setattr(tat, "_CALIBRATED", None)
    monkeypatch.setattr(jat, "_CALIBRATED", None)


def ab(csr, k, seed=1337):
    return bt.make_dense(csr.rows, k, seed=seed), \
        bt.make_dense(k, csr.cols, seed=seed + 1)


def test_cost_tables_and_candidates_equal():
    assert tat.V5E_COSTS == jat.V5E_COSTS
    assert list(tat.V5E_COSTS) == list(jat.V5E_COSTS)
    assert tat._LEGACY_KEYS == jat._LEGACY_KEYS
    assert tat.DELTA_CANDIDATES == jat.DELTA_CANDIDATES
    assert tat.ALPHA_CANDIDATES == jat.ALPHA_CANDIDATES
    assert tat.BIG_GATHER_BYTES == jat.BIG_GATHER_BYTES
    assert tat.CALIBRATION_KS == jat.CALIBRATION_KS


PLAN_CASES = {"bsr": (SMALL, BASE_CFG),
              "reorder": (SMALL, dict(BASE_CFG, col_mode="reorder",
                                      delta=0.1)),
              "windowed": (WIDE, WIDE_CFG)}


@pytest.mark.parametrize("out_dtype", ["float32", "float16"])
@pytest.mark.parametrize("k", [32, 128, 256])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_estimates_exactly_equal(case, k, out_dtype):
    spec, cfg_kw = PLAN_CASES[case]
    jplan, tplan = both_plans(spec, dict(cfg_kw, k=k))
    assert_same(jplan, tplan, skip=("pack_time_ms",))
    if case == "windowed":
        assert tplan.window_rows is not None
    got = tat.estimate_plan_ms(tplan, out_dtype=out_dtype)
    want = jat.estimate_plan_ms(jplan, out_dtype=out_dtype)
    assert got == want and got > 0
    assert tat._big_gather_footprint(tplan) == \
        jat._big_gather_footprint(jplan)
    args = (tplan.rows, tplan.cols, tplan.nnz, k)
    assert tat.estimate_dense_ms(*args) == jat.estimate_dense_ms(*args)


def both_pipes(spec, cfg_kw):
    jcsr, tcsr = j_random_mask(**spec), random_mask(**spec)
    return (JBsmrSddmm(jcsr, JConfig(**cfg_kw)),
            bt.BsmrSddmm(tcsr, TConfig(**cfg_kw), device="cpu"))


def assert_same_choice(jc, tc):
    assert type(tc).__name__ == type(jc).__name__
    assert list(tc.candidates) == list(jc.candidates)
    assert tc.candidates == jc.candidates          # exact floats
    for name in ("alpha", "delta", "subpack", "estimated_ms", "use_dense"):
        if hasattr(jc, name):
            assert getattr(tc, name) == getattr(jc, name), name
    assert_same(jc.plan, tc.plan, skip=("pack_time_ms",))


@pytest.mark.parametrize("mask", ["auto", "dense"])
def test_choose_delta_matches_reference(mask):
    spec = AUTO if mask == "auto" else DENSE
    jpipe, tpipe = both_pipes(spec, AUTO_CFG)
    jc = jat.choose_delta(jpipe.csr, jpipe._row_reordering(0.3),
                          jpipe.config)
    tc = tat.choose_delta(tpipe.csr, tpipe._row_reordering(0.3),
                          tpipe.config)
    assert_same_choice(jc, tc)
    assert tc.use_dense == (mask == "dense")
    assert "dense" in tc.candidates
    assert tc.plan.delta_used == tc.delta


@pytest.mark.parametrize("refine_top", [0, 4])
@pytest.mark.parametrize("mask", ["auto", "dense"])
def test_choose_config_matches_reference(mask, refine_top):
    """With refine_top=4 on the CPU both keep the estimate order: the pick
    and every table entry equal the unrefined run's."""
    spec = AUTO if mask == "auto" else DENSE
    jpipe, tpipe = both_pipes(spec, AUTO_CFG)
    jc = jat.choose_config(jpipe.csr, jpipe._row_reordering, jpipe.config,
                           refine_top=refine_top)
    tc = tat.choose_config(tpipe.csr, tpipe._row_reordering, tpipe.config,
                           refine_top=refine_top, device="cpu")
    assert_same_choice(jc, tc)
    assert not any(key[0] == "measured" for key in tc.candidates
                   if isinstance(key, tuple))
    if mask == "auto":
        tiled = {key: v for key, v in tc.candidates.items()
                 if key != "dense"}
        assert len({a for a, _, _ in tiled}) >= 2   # alphas not all deduped
        assert not tc.use_dense
        assert tc.candidates[(tc.alpha, tc.delta, tc.subpack)] == \
            min(tiled.values())
    # the pipeline's choose reads autotune_refine_top
    tc2 = bt.BsmrSddmm(tpipe.csr, tpipe.config.replace(
        autotune_refine_top=refine_top), device="cpu").choose(alpha="auto")
    assert (tc2.alpha, tc2.delta, tc2.subpack) == \
        (tc.alpha, tc.delta, tc.subpack)


def test_refine_keeps_estimate_order_without_a_card():
    kept = [(1.0, 0.1, 0.02, 0, None), (2.0, 0.3, 0.02, 0, None)]
    cfg = TConfig(**AUTO_CFG)
    assert tat._refine_measure(kept, cfg, 32, None) is None
    assert tat._refine_measure(kept, cfg, 32, "cpu") is None


def test_merge_costs_maps_legacy_keys():
    """tests/test_harness.py:459-471, on both packages."""
    for loaded in ({"dense_tile_floor_ns": 80.0, "gathered_base_ns": 500.0},
                   {"pernnz_ns": 7.5, "packed_tile_ns": 190.0,
                    "dense_step_overhead_ns": 210.0},
                   {}):
        assert tat._merge_costs(loaded) == jat._merge_costs(loaded)
    merged = tat._merge_costs({"dense_tile_floor_ns": 80.0,
                               "gathered_base_ns": 500.0})
    slope = tat.V5E_COSTS["dense_floor_k_ns"]
    assert merged["dense_floor_base_ns"] == pytest.approx(80.0 - slope * 128)
    assert merged["dense_floor_k_ns"] == slope
    assert merged["gathered_base_ns"] == 500.0
    assert tat._affine(merged, "dense_floor", 128) == pytest.approx(80.0)


def test_current_costs_without_cuda_is_v5e(monkeypatch, tmp_path):
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tat.current_costs() is tat.V5E_COSTS
    assert jat.current_costs() is jat.V5E_COSTS


def test_cost_cache_write_then_read(monkeypatch, tmp_path):
    """A table stored for a card is what current_costs() returns on it,
    from tier_costs_<device name>.json under BSMR_CACHE_DIR."""
    name = "NVIDIA H100 80GB HBM3"
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert tat.current_costs() is tat.V5E_COSTS       # nothing stored yet
    costs = dict(tat.V5E_COSTS, dense_floor_base_ns=11.5, gathered_k_ns=0.3,
                 sampled_dot_tflops=99.0)
    path = tat._store_costs(costs, name)
    assert path == os.path.join(str(tmp_path),
                                "tier_costs_NVIDIA_H100_80GB_HBM3.json")
    assert path == jat._cache_path(name)              # the JAX file name
    got = tat.current_costs()
    assert got["dense_floor_base_ns"] == 11.5 and got["gathered_k_ns"] == 0.3
    # only the refit keys are stored: the dense arm keeps the v5e rate
    assert got["sampled_dot_tflops"] == tat.V5E_COSTS["sampled_dot_tflops"]
    assert tat._CALIBRATED is got


def test_cache_dir_defaults_to_checkout_build(monkeypatch):
    monkeypatch.delenv("BSMR_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert tat._cache_path("x y") == os.path.join(root, "build",
                                                  "tier_costs_x_y.json")


BASE_NS, SLOPE_NS = 400.0, 1.5


def test_calibrate_recovers_affine_costs(monkeypatch, tmp_path):
    """calibrate() on its own synthetic masks, cut 8x per side, with the
    tier timer replaced by a known line: BASE_NS + SLOPE_NS * K per unit
    (tile, or nonzero for the residual). Every tier body still runs once
    on the CPU. The dense floor is the line less the default step model
    over the plan's fat group G."""
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path))
    real_mask = tat.random_mask
    monkeypatch.setattr(
        tat, "random_mask",
        lambda rows, cols, nnz, **kw: real_mask(rows // 8, cols // 8,
                                                nnz // 64, **kw))
    groups = []

    def timer(body, A, Bt, dplan):
        units = body(A, Bt, dplan).shape[0]
        groups.append(dplan.tile_panel.shape[0]
                      // max(dplan.tile_src.shape[0], 1))
        return units * (BASE_NS + SLOPE_NS * A.shape[1]) / 1e6

    monkeypatch.setattr(tat, "_time_tier", timer)
    costs = tat.calibrate()
    assert len(groups) == 8 and groups[0] == groups[1] and groups[0] >= 1
    for prefix in ("packed", "gathered", "pernnz"):
        assert costs[f"{prefix}_base_ns"] == pytest.approx(BASE_NS)
        assert costs[f"{prefix}_k_ns"] == pytest.approx(SLOPE_NS)
    G = groups[0]
    v5e = tat.V5E_COSTS
    assert costs["dense_floor_base_ns"] == pytest.approx(
        BASE_NS - v5e["dense_step_base_ns"] / G)
    assert costs["dense_floor_k_ns"] == pytest.approx(
        SLOPE_NS - v5e["dense_step_k_ns"] / G)
    for key in set(v5e) - set(tat.CALIBRATED_KEYS):
        assert costs[key] == v5e[key], key
    assert tat.current_costs() is costs
    assert os.listdir(tmp_path) == []       # stored only for a CUDA card


def test_fit_affine_clamps_and_single_point():
    costs = dict(tat.V5E_COSTS)
    tat._fit_affine(costs, "gathered", [(32, 100.0), (128, 50.0)])
    assert costs["gathered_k_ns"] == 0.0            # slope clamped at 0
    tat._fit_affine(costs, "packed", [(32, None), (128, 300.0)])
    assert costs["packed_k_ns"] == tat.V5E_COSTS["packed_k_ns"]
    assert costs["packed_base_ns"] == pytest.approx(
        300.0 - tat.V5E_COSTS["packed_k_ns"] * 128)
    before = dict(costs)
    tat._fit_affine(costs, "pernnz", [(32, None)])
    assert costs == before


# ---------------------------------------------------------------------------
# baselines and the dense fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", tbase.BASELINE_NAMES)
def test_baseline_matches_reference(name):
    jcsr, tcsr = j_random_mask(**SMALL), random_mask(**SMALL)
    A, B = ab(tcsr, 32)
    Bt = np.ascontiguousarray(B.T)
    want = np.asarray(jbase.make_baseline_fn(name, jcsr, 32)(A, Bt))
    got = tbase.make_baseline_fn(name, tcsr, 32)(torch.from_numpy(A),
                                                 torch.from_numpy(Bt))
    assert got.shape == (tcsr.nnz,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert check_data(sddmm_ref(A, B, tcsr), got.numpy()).passed


@pytest.mark.parametrize("name", tbase.BASELINE_NAMES)
def test_benchmark_baseline_validates(name):
    tcsr = random_mask(**TINY)
    A, B = ab(tcsr, 32)
    log = tbase.benchmark_baseline(name, tcsr, A, B, iterations=2,
                                   validate=True, file="tiny", device="cpu")
    assert log.check_result == "pass" and log.error_rate == 0.0
    assert (log.backend, log.device, log.file) == (name, "cpu", "tiny")
    assert log.sddmm_ms > 0 and log.nnz == tcsr.nnz


def test_unknown_baseline_raises():
    with pytest.raises(ValueError, match="unknown baseline"):
        tbase.make_baseline_fn("cusparse", random_mask(**TINY), 32)


def test_dense_fallback_autotune():
    """tests/test_harness.py:499-533 on the port: a near-uniform mask
    prices the dense arm and the forced fallback matches the JAX
    package's; blocky masks stay tiled; a small dense mask falls back."""
    cfg_kw = dict(k=32, panel_height=16, num_iterations=2)
    uni, juni = uniform(4096, 350_000, seed=9), j_uniform(4096, 350_000,
                                                          seed=9)
    pipe = bt.BsmrSddmm(uni, TConfig(**cfg_kw), device="cpu")
    assert "dense" in pipe.choose().candidates
    A, B = ab(uni, 32, seed=1)
    out = pipe.run(A, B, delta="dense")
    ref = JBsmrSddmm(juni, JConfig(**cfg_kw)).run(A, B, delta="dense")
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert check_data(sddmm_ref(A, B, uni), out).passed
    log = pipe.benchmark(A, B, delta="dense", validate=True, file="uni")
    assert log.extras.get("strategy") == "dense_fallback"
    assert log.check_result == "pass" and np.isnan(log.delta)
    blocky = random_mask(rows=16384, cols=16384, nnz=300_000, seed=3,
                         block_rows=32, block_cols=256)
    choice = bt.BsmrSddmm(blocky, TConfig(**cfg_kw)).choose()
    assert not choice.use_dense, choice.candidates
    assert bt.BsmrSddmm(random_mask(**DENSE), TConfig(**cfg_kw)).choose(
        ).use_dense


# ---------------------------------------------------------------------------
# the pipeline and the CLI
# ---------------------------------------------------------------------------

AUTO_CALLS = {"delta_auto": dict(delta="auto"),
              "alpha_auto": dict(alpha="auto", delta="auto")}


@pytest.mark.parametrize("call", sorted(AUTO_CALLS))
def test_auto_benchmark_and_run_match_reference(call):
    """tests/test_harness.py:329 and :353 on both packages: the logged
    alpha and delta are the JAX package's choice, and run() gives its
    values."""
    kw = AUTO_CALLS[call]
    jpipe, tpipe = both_pipes(AUTO, AUTO_CFG)
    A, B = ab(tpipe.csr, 32)
    log = tpipe.benchmark(A, B, validate=True, file="auto", **kw)
    ref = jpipe.benchmark(A, B, validate=True, **kw)
    assert log.check_result == "pass"
    assert (log.alpha, log.delta) == (ref.alpha, ref.delta)
    assert log.delta in tat.DELTA_CANDIDATES
    for name in ("num_clusters", "num_dense_blocks", "num_packed_blocks",
                 "num_gathered_blocks", "residual_nnz"):
        assert getattr(log, name) == getattr(ref, name), name
    np.testing.assert_allclose(tpipe.run(A, B, **kw), jpipe.run(A, B, **kw),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="auto"):
        tpipe.plan(alpha="auto", delta=0.3)


def test_cli_auto_flags(tmp_path, capsys):
    path = str(tmp_path / "auto.mtx")
    save_mtx(path, random_mask(**AUTO))
    logs = tmp_path / "logs"
    rc = cli.main(["-f", path, "-k", "32", "--panel-height", "16",
                   "--iterations", "1", "--device", "cpu", "--auto-delta",
                   "--auto-alpha", "--refine-top", "3", "--validate",
                   "-l", str(logs)])
    assert rc == 0
    rec = parse_log_text(capsys.readouterr().out)[-1]
    assert rec["checkResults"] == "pass"
    assert float(rec["alpha"]) in tat.ALPHA_CANDIDATES
    assert float(rec["delta"]) in tat.DELTA_CANDIDATES
    assert os.listdir(logs) == ["BSMR_k_32_a_auto_d_auto.log"]
