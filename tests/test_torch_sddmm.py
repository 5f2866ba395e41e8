"""The port's SDDMM body and pipeline against the JAX package's.

One TilePlan, packed by the JAX package and carried across with
``interop.plan_from_reference``, goes to both bodies with the same A and
Bt (NumPy, fixed seeds). The JAX body runs as its tests run it on the CPU
(``backend="xla"``; with ``gathered_backend="fused"`` its gathered tier is
the Pallas kernel in interpret mode). Tiers are compared on real slots only
(scatter index < nnz) at rtol 1e-5 / atol 1e-5: both sides are fp32 and
differ only in the order of summation, so the fused cases run the Pallas
kernel at ``matmul_precision="highest"``; at its default bf16x3 split they
are compared at the check_data tolerance (abs 1e-5 OR rel 1e-3). fp16
output is compared at the check_data tolerance (each side rounds once to
fp16). Each ``matmul_precision`` is held to the JAX body at the same
setting at the check_data tolerance ("default": the port's one TF32 pass
against the JAX CPU's fp32), and ``_serialize_tiers`` to the JAX
function on the same plan and cost table; the bodies at each
``tier_serialize`` are bit-identical (on the CPU they all run one stream:
the two streams are tested on the card), and which calls fork. Then the whole slice:
BsmrSddmm.benchmark (``tier_times`` included), sddmm() and the CLI
(``--col-mode reorder``, ``--evaluate``, ``--tier-times``,
``--reorder-cache``). The body on the card is tested in
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
from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.ops import sddmm as tops
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
    "reorder": (SMALL, dict(col_mode="reorder")),
    "reorder_delta_0": (SMALL, dict(col_mode="reorder", delta=0.0)),
    "reorder_delta_0.05": (SMALL, dict(col_mode="reorder", delta=0.05)),
    "reorder_delta_1.1": (SMALL, dict(col_mode="reorder", delta=1.1)),
    "fused": (SMALL, dict(gathered_backend="fused",
                          matmul_precision="highest")),
    "reorder_fused": (SMALL, dict(col_mode="reorder", delta=0.1,
                                  gathered_backend="fused",
                                  matmul_precision="highest")),
    "windowed_fused": (WIDE, dict(gathered_backend="fused")),
    "windowed_reorder": (WIDE, dict(col_mode="reorder", delta=0.5)),
}


def body_cfg(case):
    spec, extra = BODY_CASES[case]
    return spec, dict(WIDE_CFG if spec is WIDE else BASE_CFG, **extra)


@pytest.mark.parametrize("case", sorted(BODY_CASES))
def test_body_matches_reference_tier_by_tier(case):
    spec, cfg_kw = body_cfg(case)
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
    if case.startswith("reorder"):
        assert tplan.mode == "reorder"
    if case in ("reorder", "reorder_fused"):
        assert tplan.num_tiles and tplan.num_packed and tplan.num_gathered


def launch_counts():
    return {name: getattr(dk, name).launches for name in
            ("bsr_dense", "subpack", "dense_tile", "fused_gathered")}


@pytest.mark.parametrize("case", ["fused", "reorder_fused", "windowed_fused"])
def test_fused_arm_follows_reference(case, monkeypatch):
    """The gathered tier takes fused_gathered exactly where the JAX body
    takes its fused Pallas arm: not on windowed plans (g_groups)."""
    spec, cfg_kw = body_cfg(case)
    _, _, _, tcfg, tplan = reference_case(spec, cfg_kw)
    calls = []
    real = dk.fused_gathered
    monkeypatch.setattr(dk, "fused_gathered",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    A, Bt = operands(spec["rows"], spec["cols"], tcfg.k)
    make_sddmm_body(tplan, tcfg, only_tier="gathered")(
        torch.from_numpy(A), torch.from_numpy(Bt),
        device_plan(tplan, "cpu", emit="rphm"))
    windowed = tplan.g_groups is not None
    assert windowed == (case == "windowed_fused")
    assert len(calls) == (0 if windowed else 1)


@pytest.mark.parametrize("case", ["fused", "reorder_fused"])
def test_fused_body_at_default_precision(case):
    """At the JAX default bf16x3 split the fused Pallas kernel is not an
    exact fp32 product: compared at the check_data tolerance."""
    spec, cfg_kw = body_cfg(case)
    cfg_kw = dict(cfg_kw, matmul_precision="bf16x3")
    jcsr, jcfg, jplan, tcfg, tplan = reference_case(spec, cfg_kw)
    A, Bt = operands(spec["rows"], spec["cols"], tcfg.k)
    ref = jax_body(jplan, jcfg, A, Bt, "csr")
    got = make_sddmm_body(tplan, tcfg, emit="csr")(
        torch.from_numpy(A), torch.from_numpy(Bt),
        device_plan(tplan, "cpu")).numpy()
    res = check_data(ref, got)
    assert res.passed, str(res)


@pytest.mark.parametrize("case", ["default", "delta_1.1", "windowed",
                                  "reorder", "reorder_fused"])
def test_body_csr_matches_reference(case):
    spec, cfg_kw = body_cfg(case)
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


@pytest.mark.parametrize("delta", [0.0, 0.3, 1.1])
def test_reorder_body_fp16_matches_reference(delta):
    cfg_kw = dict(BASE_CFG, delta=delta, out_dtype="float16",
                  col_mode="reorder")
    _, jcfg, jplan, tcfg, tplan = reference_case(SMALL, cfg_kw)
    A, Bt = operands(SMALL["rows"], SMALL["cols"], tcfg.k)
    ref = jax_body(jplan, jcfg, A, Bt, "csr")
    got = make_sddmm_body(tplan, tcfg, emit="csr")(
        torch.from_numpy(A), torch.from_numpy(Bt),
        device_plan(tplan, "cpu")).numpy()
    assert got.dtype == np.float16 and ref.dtype == np.float16
    res = check_data(ref, got)
    assert res.passed, str(res)


@pytest.mark.parametrize("case", ["default", "reorder_fused"])
def test_only_tier_and_backends_agree(case):
    spec, cfg_kw = body_cfg(case)
    _, _, _, tcfg, tplan = reference_case(spec, cfg_kw)
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


#: plans for the tier_serialize rule: windowed with the residual priced
#: above 0.45 of the call ("auto" serializes), the same mask unwindowed
#: (a small gather footprint), and a small plan
SERIALIZE_PLANS = {
    "windowed_residual": (WIDE, dict(WIDE_CFG, delta=1.1)),
    "unwindowed": (WIDE, dict(WIDE_CFG, gather_window_mb=0)),
    "small": (SMALL, BASE_CFG),
}


@pytest.mark.parametrize("mode", ["auto", "on", "off", True, False])
@pytest.mark.parametrize("case", sorted(SERIALIZE_PLANS))
def test_serialize_tiers_matches_reference(case, mode):
    spec, cfg_kw = SERIALIZE_PLANS[case]
    _, jcfg, jplan, tcfg, tplan = reference_case(
        spec, dict(cfg_kw, tier_serialize=mode))
    got = tops._serialize_tiers(tplan, tcfg)
    assert got == jops._serialize_tiers(jplan, jcfg)
    if mode == "auto":
        assert got == (case == "windowed_residual")
        assert (tplan.window_rows is not None) == got
    else:
        assert got == (mode in ("on", True))


@pytest.mark.parametrize("case", ["default", "windowed", "reorder_fused"])
def test_tier_serialize_arms_are_bit_identical(case):
    """tests/test_sddmm.py::test_tier_serialize_matches_default, mirrored:
    the arm is scheduling only, the values are the same bit for bit."""
    spec, cfg_kw = body_cfg(case)
    _, _, _, tcfg, tplan = reference_case(spec, cfg_kw)
    A, Bt = operands(spec["rows"], spec["cols"], tcfg.k)
    A, Bt = torch.from_numpy(A), torch.from_numpy(Bt)
    dplan = device_plan(tplan, "cpu", emit="rphm")
    bodies = [make_sddmm_body(tplan, tcfg.replace(tier_serialize=mode),
                              emit="rphm") for mode in ("auto", "on", "off")]
    outs = [body(A, Bt, dplan) for body in bodies]
    for other in outs[1:]:
        for tier, a, b in zip(TIERS, outs[0], other):
            assert torch.equal(a, b), tier
    assert [body.forks for body in bodies] == [0, 0, 0]   # CPU tensors


@pytest.mark.parametrize("capturing", [False, True])
@pytest.mark.parametrize("mode", ["auto", "off", False])
def test_overlapping_calls_fork_eagerly_only_when_asked(mode, capturing):
    """Where _serialize_tiers lets the tiers overlap, "off" forks every
    call and "auto" only a call captured into a CUDA graph."""
    cfg = bt.SddmmConfig(tier_serialize=mode)
    assert tops._forks(cfg, capturing) == (mode != "auto" or capturing)


@pytest.mark.parametrize("precision", ["default", "bf16x3", "high",
                                       "highest"])
@pytest.mark.parametrize("case", ["default", "reorder", "fused",
                                  "reorder_fused"])
def test_each_matmul_precision_matches_reference(case, precision):
    """Every tier (real slots) and the CSR output against the JAX body at
    the same matmul_precision (its fused arm the Pallas kernel in interpret
    mode), at the check_data tolerance; each passes the fp64 oracle."""
    spec, cfg_kw = body_cfg(case)
    cfg_kw = dict(cfg_kw, matmul_precision=precision)
    jcsr, jcfg, jplan, tcfg, tplan = reference_case(spec, cfg_kw)
    A, Bt = operands(spec["rows"], spec["cols"], tcfg.k)
    ref = jax_body(jplan, jcfg, A, Bt, "rphm")
    got = make_sddmm_body(tplan, tcfg, emit="rphm")(
        torch.from_numpy(A), torch.from_numpy(Bt),
        device_plan(tplan, "cpu", emit="rphm"))
    for tier, r, g in zip(TIERS, ref, got):
        real = real_slots(tplan, tier)
        res = check_data(r[real], g.numpy()[real])
        assert res.passed, f"{tier}: {res}"
    got_csr = make_sddmm_body(tplan, tcfg)(
        torch.from_numpy(A), torch.from_numpy(Bt),
        device_plan(tplan, "cpu")).numpy()
    assert check_data(jax_body(jplan, jcfg, A, Bt, "csr"), got_csr).passed
    assert check_data(sddmm_ref(A, Bt.T, jcsr), got_csr).passed
    # one pass reaches the tile tiers; the three-pass settings agree
    three = make_sddmm_body(tplan, tcfg.replace(matmul_precision="high"))(
        torch.from_numpy(A), torch.from_numpy(Bt),
        device_plan(tplan, "cpu")).numpy()
    assert np.array_equal(got_csr, three) == (precision != "default")


@pytest.mark.parametrize("precision", ["default", "bf16x3"])
def test_body_sets_the_torch_tiers_tf32_flag(precision, monkeypatch):
    """The unfused gathered tier's bmm runs with allow_tf32 as the config
    says (fault 3: not as the caller set it); the plain kernel versions'
    bmm always with it off; the caller's flag is put back."""
    spec, cfg_kw = body_cfg("default")
    _, _, _, tcfg, tplan = reference_case(
        spec, dict(cfg_kw, matmul_precision=precision))
    assert tplan.num_gathered and tcfg.gathered_backend == "xla"
    # the gathered tier's bmm is told apart by its batch, Tg tiles
    Tg = tplan.g_panel.shape[0]
    assert Tg not in (tplan.tile_panel.shape[0], tplan.sp_panel.shape[0])
    seen = []
    real_bmm = torch.bmm

    def bmm(a, b):
        seen.append((a.shape[0], torch.backends.cuda.matmul.allow_tf32))
        return real_bmm(a, b)

    monkeypatch.setattr(torch, "bmm", bmm)
    A, Bt = operands(spec["rows"], spec["cols"], tcfg.k)
    for caller in (False, True):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", caller)
        seen.clear()
        make_sddmm_body(tplan, tcfg, emit="rphm")(
            torch.from_numpy(A), torch.from_numpy(Bt),
            device_plan(tplan, "cpu", emit="rphm"))
        assert torch.backends.cuda.matmul.allow_tf32 is caller
        gathered = [flag for n, flag in seen if n == Tg]
        kernels = [flag for n, flag in seen if n != Tg]
        assert gathered == [precision == "default"]
        assert kernels and not any(kernels)


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
    assert float(log.extras["sddmm_eager_ms"]) > 0
    for name in ("num_clusters", "num_row_panels", "num_dense_blocks",
                 "num_packed_blocks", "num_gathered_blocks", "dense_nnz",
                 "packed_nnz", "gathered_nnz", "residual_nnz",
                 "average_tile_density", "m", "n", "nnz"):
        assert getattr(log, name) == getattr(ref, name), name
    rec = parse_log_text(log.to_text())[0]
    assert rec["File"] == "small" and rec["checkResults"] == "pass"


TIER_KEYS = ("tier_dense_ms", "tier_packed_ms", "tier_gathered_ms",
             "tier_residual_ms", "tier_overlap_efficiency")


@pytest.mark.parametrize("kw", [{}, dict(col_mode="reorder", delta=0.1,
                                         gathered_backend="fused")],
                         ids=["bsr", "reorder_fused"])
def test_benchmark_tier_times_matches_reference_keys(kw):
    cfg_kw = dict(BASE_CFG, num_iterations=1, **kw)
    jcsr, tcsr = j_random_mask(**SMALL), random_mask(**SMALL)
    A = bt.make_dense(tcsr.rows, 32, seed=1337)
    B = bt.make_dense(32, tcsr.cols, seed=1338)
    before = launch_counts()
    log = bt.BsmrSddmm(tcsr, bt.SddmmConfig(**cfg_kw), device="cpu"
                       ).benchmark(A, B, validate=True, tier_times=True)
    ref = JBsmrSddmm(jcsr, JConfig(**cfg_kw)).benchmark(
        A, B, validate=True, tier_times=True)
    assert log.check_result == "pass"
    assert launch_counts() == before     # CPU tensors launch no kernel
    port_keys = [k for k in log.extras if k.startswith("tier_")]
    ref_keys = [k for k in ref.extras if k.startswith("tier_")]
    assert port_keys == ref_keys == list(TIER_KEYS)
    assert all(float(log.extras[k]) > 0 for k in TIER_KEYS)
    for name in ("num_dense_blocks", "num_packed_blocks",
                 "num_gathered_blocks", "dense_nnz", "residual_nnz"):
        assert getattr(log, name) == getattr(ref, name), name


@pytest.mark.parametrize("kw", [{}, dict(delta=0.0, out_dtype="float16"),
                                dict(delta=1.1, dense_fat_group=1),
                                dict(col_mode="reorder", delta=0.1),
                                dict(col_mode="reorder", delta=0.1,
                                     gathered_backend="fused",
                                     matmul_precision="highest")])
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


@pytest.mark.parametrize("call", ["delta_auto", "alpha_auto", "dense"])
def test_auto_and_dense_features_run(call):
    """The autotuned and dense-fallback calls run and validate (on this
    tiny mask the cost model picks the fallback); the arm selection itself
    is held against the JAX package in tests/test_torch_autotune.py."""
    tcsr = random_mask(**TINY)
    A = bt.make_dense(tcsr.rows, 32)
    B = bt.make_dense(32, tcsr.cols)
    cfg = bt.SddmmConfig(**dict(BASE_CFG, num_iterations=1))
    kw = {"delta_auto": dict(delta="auto"),
          "alpha_auto": dict(alpha="auto", delta="auto"),
          "dense": dict(delta="dense")}[call]
    pipe = bt.BsmrSddmm(tcsr, cfg, device="cpu")
    log = pipe.benchmark(A, B, validate=True, **kw)
    assert log.check_result == "pass"
    assert log.extras.get("strategy") == "dense_fallback"
    assert check_data(sddmm_ref(A, B, tcsr), pipe.run(A, B, **kw)).passed


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


def test_cli_reorder_evaluate_tier_times_cache(tmp_path, capsys,
                                              monkeypatch):
    cache = tmp_path / "cache"
    monkeypatch.setenv("BSMR_CACHE_DIR", str(cache))
    tcsr = random_mask(**SMALL)
    path = str(tmp_path / "small.mtx")
    save_mtx(path, tcsr)
    argv = ["-f", path, "-k", "32", "-a", "0.3", "-d", "0.1",
            "--panel-height", "16", "--iterations", "1", "--device", "cpu",
            "--col-mode", "reorder", "--evaluate", "--tier-times",
            "--reorder-cache", "--validate"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "[checkResults : pass]" in out
    rec = parse_log_text(out)[-1]
    for key in ("denseBlockGain", "denseCoverage", "numDenseBlocksOriginal",
                "tier_dense_ms", "tier_overlap_efficiency"):
        assert key in rec, key
    assert len(list(cache.glob("*.npz"))) == 1
    assert cli.main(argv) == 0                  # second run: cache hit
    assert "[checkResults : pass]" in capsys.readouterr().out


@pytest.mark.parametrize("flag,log_name", [
    (["--auto-delta"], "BSMR_k_32_a_0.3_d_auto.log"),
    (["--auto-alpha"], "BSMR_k_32_a_auto_d_auto.log"),
    (["--refine-top", "3"], "BSMR_k_32_a_0.3_d_0.3.log")])
def test_cli_autotune_flags_run(tmp_path, capsys, flag, log_name):
    """The JAX CLI's log names: --auto-alpha implies --auto-delta, and
    --refine-top alone changes nothing."""
    path = str(tmp_path / "tiny.mtx")
    save_mtx(path, random_mask(**TINY))
    logs = tmp_path / "logs"
    assert cli.main(["-f", path, "--device", "cpu", "--iterations", "1",
                     "--validate", "-l", str(logs)] + flag) == 0
    assert "[checkResults : pass]" in capsys.readouterr().out
    assert [p.name for p in logs.iterdir()] == [log_name]
