"""The port's SDDMM body and pipeline against the JAX package's.

One TilePlan, packed by the JAX package and carried across with
``interop.plan_from_reference``, goes to both bodies with the same A and
Bt (NumPy, fixed seeds). The JAX body runs as its tests run it on the CPU
(``backend="xla"``). Tiers are compared on real slots only (scatter index
< nnz) at rtol 1e-5 / atol 1e-5: both sides are fp32 and differ only in
the order of summation. fp16 output is compared at the check_data tolerance
(each side rounds once to fp16). Then the whole slice: BsmrSddmm.benchmark,
sddmm() and the CLI. The body on the card is tested in
tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsmr_sddmm_tpu.ops.sddmm as jops
from bsmr_sddmm_tpu.config import SddmmConfig as JConfig
from bsmr_sddmm_tpu.formats import random_mask as j_random_mask
from bsmr_sddmm_tpu.pack import pack_tiles as j_pack_tiles
from bsmr_sddmm_tpu.reorder import bsmr as j_bsmr
from bsmr_sddmm_tpu.sddmm import BsmrSddmm as JBsmrSddmm
from bsmr_sddmm_tpu.sddmm import sddmm as j_sddmm
from bsmr_sddmm_tpu.utils.checkdata import check_data

import bsmr_sddmm_tpu_torch as bt
from bsmr_sddmm_tpu_torch import cli
from bsmr_sddmm_tpu_torch.formats import random_mask, save_mtx
from bsmr_sddmm_tpu_torch.interop import (config_from_reference,
                                          plan_from_reference)
from bsmr_sddmm_tpu_torch.ops.sddmm import (device_plan, make_sddmm_body,
                                            sddmm_ref)
from bsmr_sddmm_tpu_torch.utils.logger import parse_log_text

SMALL = dict(rows=512, cols=768, nnz=20000, seed=7, block_rows=24,
             block_cols=96)
TINY = dict(rows=96, cols=160, nnz=900, seed=3, block_rows=12,
            block_cols=40)
BASE_CFG = dict(k=32, panel_height=16, block_width=128, dense_chunk=64,
                residual_chunk=4096)
WIDE = dict(rows=1024, cols=40960, nnz=80000, seed=31, block_rows=16,
            block_cols=64)
WIDE_CFG = dict(k=32, panel_height=16, dense_chunk=16, residual_chunk=2048,
                delta=0.9, gather_window_mb=1, gather_window_threshold_mb=2)
TIERS = ("dense", "packed", "gathered", "residual")


def operands(rows, cols, k, seed=5):
    A = bt.make_dense(rows, k, seed=seed)
    Bt = bt.make_dense(cols, k, seed=seed + 1)
    return A, Bt


def reference_case(spec, cfg_kw):
    """The JAX package's plan and config, and the port's copies."""
    jcfg = JConfig(**cfg_kw)
    jcsr = j_random_mask(**spec)
    jplan = j_pack_tiles(jcsr, j_bsmr(jcsr, jcfg), jcfg)
    return jcsr, jcfg, jplan, config_from_reference(jcfg), \
        plan_from_reference(jplan)


def real_slots(plan, tier):
    """Boolean mask of a tier's output slots that hold a nonzero."""
    if tier == "residual":
        return plan.res_out < plan.nnz
    scatter = {"dense": plan.tile_scatter, "packed": plan.sp_scatter,
               "gathered": plan.g_scatter}[tier]
    return scatter < plan.nnz


def jax_body(jplan, jcfg, A, Bt, emit):
    fn = jops.make_sddmm_body(jplan, jcfg, backend="xla", emit=emit)
    out = fn(jnp.asarray(A), jnp.asarray(Bt),
             jops.device_plan(jplan, emit=emit))
    return [np.asarray(o) for o in out] if emit == "rphm" else \
        np.asarray(out)


BODY_CASES = {
    "default": (SMALL, {}),
    "fat_group_1": (SMALL, dict(dense_fat_group=1)),
    "delta_0": (SMALL, dict(delta=0.0)),
    "delta_1.1": (SMALL, dict(delta=1.1)),
    "subpack_0": (SMALL, dict(subpack_min_nnz=0)),
    "ph32_k64": (SMALL, dict(panel_height=32, k=64)),
    "windowed": (WIDE, {}),
}


@pytest.mark.parametrize("case", sorted(BODY_CASES))
def test_body_matches_reference_tier_by_tier(case):
    spec, extra = BODY_CASES[case]
    cfg_kw = dict(WIDE_CFG if case == "windowed" else BASE_CFG, **extra)
    _, jcfg, jplan, tcfg, tplan = reference_case(spec, cfg_kw)
    A, Bt = operands(spec["rows"], spec["cols"], tcfg.k)
    ref = jax_body(jplan, jcfg, A, Bt, "rphm")
    got = make_sddmm_body(tplan, tcfg, emit="rphm")(
        torch.from_numpy(A), torch.from_numpy(Bt),
        device_plan(tplan, "cpu", emit="rphm"))
    for tier, r, g in zip(TIERS, ref, got):
        g = g.numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, tier
        real = real_slots(tplan, tier)
        np.testing.assert_allclose(g[real], r[real], rtol=1e-5, atol=1e-5,
                                   err_msg=tier)
    if case == "windowed":
        assert tplan.g_groups or tplan.res_groups


@pytest.mark.parametrize("case", ["default", "delta_1.1", "windowed"])
def test_body_csr_matches_reference(case):
    spec, extra = BODY_CASES[case]
    cfg_kw = dict(WIDE_CFG if case == "windowed" else BASE_CFG, **extra)
    jcsr, jcfg, jplan, tcfg, tplan = reference_case(spec, cfg_kw)
    A, Bt = operands(spec["rows"], spec["cols"], tcfg.k)
    ref = jax_body(jplan, jcfg, A, Bt, "csr")
    got = make_sddmm_body(tplan, tcfg, emit="csr")(
        torch.from_numpy(A), torch.from_numpy(Bt),
        device_plan(tplan, "cpu")).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert check_data(sddmm_ref(A, Bt.T, jcsr), got).passed


@pytest.mark.parametrize("delta", [0.0, 0.3, 1.1])
def test_body_fp16_matches_reference(delta):
    cfg_kw = dict(BASE_CFG, delta=delta, out_dtype="float16")
    _, jcfg, jplan, tcfg, tplan = reference_case(SMALL, cfg_kw)
    A, Bt = operands(SMALL["rows"], SMALL["cols"], tcfg.k)
    ref = jax_body(jplan, jcfg, A, Bt, "csr")
    got = make_sddmm_body(tplan, tcfg, emit="csr")(
        torch.from_numpy(A), torch.from_numpy(Bt),
        device_plan(tplan, "cpu")).numpy()
    assert got.dtype == np.float16 and ref.dtype == np.float16
    res = check_data(ref, got)
    assert res.passed, str(res)


def test_only_tier_and_backends_agree():
    _, _, _, tcfg, tplan = reference_case(SMALL, BASE_CFG)
    A, Bt = operands(SMALL["rows"], SMALL["cols"], tcfg.k)
    A, Bt = torch.from_numpy(A), torch.from_numpy(Bt)
    dplan = device_plan(tplan, "cpu", emit="rphm")
    full = make_sddmm_body(tplan, tcfg, emit="rphm")(A, Bt, dplan)
    plain = make_sddmm_body(tplan, tcfg, backend="torch",
                            emit="rphm")(A, Bt, dplan)
    for tier, f, p in zip(TIERS, full, plain):
        one = make_sddmm_body(tplan, tcfg, only_tier=tier)(A, Bt, dplan)
        torch.testing.assert_close(one, f, rtol=0, atol=0)
        torch.testing.assert_close(p, f, rtol=0, atol=0)


def test_light_device_plan_leaves_maps_empty():
    _, _, _, _, tplan = reference_case(TINY, BASE_CFG)
    light = device_plan(tplan, "cpu", emit="rphm")
    full = device_plan(tplan, "cpu")
    for name in ("tile_scatter", "sp_scatter", "g_scatter", "res_out",
                 "rphm_to_csr"):
        assert getattr(light, name).numel() == 0
        assert getattr(full, name).numel() == getattr(tplan, name).size
    for t in full:
        assert t.dtype == torch.int32


def test_config_from_reference_maps_backend():
    for ref, port in (("xla", "torch"), ("pallas", "auto"),
                      ("auto", "auto")):
        cfg = config_from_reference(JConfig(backend=ref, k=64, delta=0.1))
        assert (cfg.backend, cfg.k, cfg.delta) == (port, 64, 0.1)


# ---------------------------------------------------------------------------
# the whole slice on the CPU
# ---------------------------------------------------------------------------

def test_benchmark_passes_and_matches_reference_log():
    kw = dict(BASE_CFG, num_iterations=2)
    jcsr, tcsr = j_random_mask(**SMALL), random_mask(**SMALL)
    A = bt.make_dense(tcsr.rows, 32, seed=1337)
    B = bt.make_dense(32, tcsr.cols, seed=1338)
    log = bt.BsmrSddmm(tcsr, bt.SddmmConfig(**kw), device="cpu").benchmark(
        A, B, validate=True, file="small")
    ref = JBsmrSddmm(jcsr, JConfig(**kw)).benchmark(A, B, validate=True)
    assert log.check_result == "pass" and log.error_rate == 0.0
    assert log.device == "cpu"
    for name in ("num_clusters", "num_row_panels", "num_dense_blocks",
                 "num_packed_blocks", "num_gathered_blocks", "dense_nnz",
                 "packed_nnz", "gathered_nnz", "residual_nnz",
                 "average_tile_density", "m", "n", "nnz"):
        assert getattr(log, name) == getattr(ref, name), name
    rec = parse_log_text(log.to_text())[0]
    assert rec["File"] == "small" and rec["checkResults"] == "pass"


@pytest.mark.parametrize("kw", [{}, dict(delta=0.0, out_dtype="float16"),
                                dict(delta=1.1, dense_fat_group=1)])
def test_sddmm_matches_reference(kw):
    cfg_kw = dict(BASE_CFG, **kw)
    jcsr, tcsr = j_random_mask(**SMALL), random_mask(**SMALL)
    A = bt.make_dense(tcsr.rows, 32, seed=11)
    B = bt.make_dense(32, tcsr.cols, seed=12)
    ref = j_sddmm(A, B, jcsr, JConfig(**cfg_kw))
    got = bt.sddmm(A, B, tcsr, bt.SddmmConfig(**cfg_kw), device="cpu")
    assert got.dtype == ref.dtype
    if got.dtype == np.float16:
        assert check_data(ref, got).passed
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_run_takes_tensors_and_pretransposed_b():
    tcsr = random_mask(**TINY)
    A = bt.make_dense(tcsr.rows, 32, seed=1)
    B = bt.make_dense(32, tcsr.cols, seed=2)
    pipe = bt.BsmrSddmm(tcsr, bt.SddmmConfig(**BASE_CFG))
    out1 = pipe.run(torch.from_numpy(A), torch.from_numpy(B))  # CPU tensors
    out2 = bt.BsmrSddmm(tcsr, bt.SddmmConfig(**BASE_CFG), device="cpu").run(
        A, np.ascontiguousarray(B.T))
    np.testing.assert_allclose(out1, out2, rtol=1e-6)
    assert check_data(sddmm_ref(A, B, tcsr), out1).passed


def test_no_cuda_needs_explicit_cpu(monkeypatch):
    """Without a card and without device='cpu', numpy inputs raise rather
    than silently running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcsr = random_mask(**TINY)
    A = bt.make_dense(tcsr.rows, 32)
    B = bt.make_dense(32, tcsr.cols)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.BsmrSddmm(tcsr, bt.SddmmConfig(**BASE_CFG)).run(A, B)


@pytest.mark.parametrize("call", ["delta_auto", "alpha_auto", "dense",
                                  "tier_times", "reorder_cache",
                                  "col_mode", "fused"])
def test_unported_features_raise(call):
    tcsr = random_mask(**TINY)
    A = bt.make_dense(tcsr.rows, 32)
    B = bt.make_dense(32, tcsr.cols)
    cfg = bt.SddmmConfig(**BASE_CFG)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if call == "fused":
            bt.SddmmConfig(gathered_backend="fused")
        kw = {"delta_auto": dict(delta="auto"),
              "alpha_auto": dict(alpha="auto", delta="auto"),
              "dense": dict(delta="dense"),
              "tier_times": dict(tier_times=True)}.get(call, {})
        if call == "reorder_cache":
            cfg = cfg.replace(reorder_cache=True)
        if call == "col_mode":
            cfg = cfg.replace(col_mode="reorder")
        bt.BsmrSddmm(tcsr, cfg, device="cpu").benchmark(A, B, **kw)


def test_cli_validates(tmp_path, capsys):
    tcsr = random_mask(**SMALL)
    path = str(tmp_path / "small.mtx")
    save_mtx(path, tcsr)
    logs = tmp_path / "logs"
    rc = cli.main(["-f", path, "-k", "32", "-a", "0.3", "-d", "0.3",
                   "--panel-height", "16", "--iterations", "2",
                   "--device", "cpu", "--validate", "-l", str(logs)])
    assert rc == 0
    rec = parse_log_text(capsys.readouterr().out)[-1]
    assert rec["checkResults"] == "pass" and rec["File"] == "small.mtx"
    assert (logs / "BSMR_k_32_a_0.3_d_0.3.log").exists()


@pytest.mark.parametrize("flag", [["--auto-delta"], ["--auto-alpha"],
                                  ["--refine-top", "3"], ["--tier-times"],
                                  ["--evaluate"], ["--reorder-cache"],
                                  ["--col-mode", "reorder"]])
def test_cli_unported_flags_exit_nonzero(tmp_path, capsys, flag):
    path = str(tmp_path / "tiny.mtx")
    save_mtx(path, random_mask(**TINY))
    assert cli.main(["-f", path, "--device", "cpu"] + flag) == 2
    assert "not yet ported" in capsys.readouterr().err
