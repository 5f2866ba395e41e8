"""The port's tile kernels: the plain PyTorch versions against the JAX
package's Pallas kernels (run with interpret=True, as tests/test_sddmm.py
runs them on the CPU), the wrappers' contract, and — on a CUDA device only —
the hand-written CUDA kernels against their plain versions.

Tolerances: rtol 1e-5 / atol 1e-5 against the Pallas kernels at
precision="highest" (both sides are fp32; only the order of summation
differs); the check_data tolerance (abs 1e-5 OR rel 1e-3) against the
default bf16x3 split. On the card, fp32 kernel vs fp32 plain at rtol 1e-5 /
atol 1e-4 on the reference's fills (values in [0, 2), K <= 256: the
tensor-core kernels' three TF32 passes drop only the lo*lo term, ~2^-22
relative per product, and sum in another order; all four kernels run on
that core), and fp16 at the check_data
tolerance (each side rounds to fp16 once: at most one fp16 ulp, rel 2^-10 <
1e-3). With inputs of mixed signs a sum can cancel, so a gate relative to
the sum means nothing: those tests hold |kernel - plain| <= 1e-5 *
(|A| . |B|^T) elementwise (plus one fp16 ulp of the plain value for fp16
output). A kernel's result is the same from launch to launch (no atomics, a
fixed order of summation): tested with torch.equal. At one TF32 pass
(``passes=1``, ``matmul_precision="default"``) the plain version is an fp32
product of the operands rounded to TF32, whose products the MMA computes
exactly: kernel and plain differ only in the order of summation, so the
same tolerances hold; against the Pallas kernels at "default" the
check_data tolerance.

The tests marked ``cuda`` import nothing of JAX, so that they run on a
machine without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels.py`` (tests/conftest.py imports jax)."""

import numpy as np
import pytest
import torch

import bsmr_sddmm_tpu_torch as bt
from bsmr_sddmm_tpu_torch import autotune, baselines
from bsmr_sddmm_tpu_torch.datasets import uniform
from bsmr_sddmm_tpu_torch.formats import random_mask
from bsmr_sddmm_tpu_torch.ops import _build
from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.ops import subpack_phases
from bsmr_sddmm_tpu_torch.ops.sddmm import (PRECISION, device_plan,
                                            make_sddmm_body, sddmm_ref)
from bsmr_sddmm_tpu_torch.utils.checkdata import check_data

BW = 128
SMALL = dict(rows=512, cols=768, nnz=20000, seed=7, block_rows=24,
             block_cols=96)
BASE_CFG = dict(k=32, panel_height=16, block_width=128, dense_chunk=64,
                residual_chunk=4096)
TIERS = ("dense", "packed", "gathered", "residual")


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none (decided here,
    at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the GPU run python -m pytest "
                    "--noconftest -m cuda tests/test_torch_kernels.py")
    return torch.device("cuda")


def fills(rng, shape, signed):
    """The reference's fills, uniform [0, 2), or standard normal values
    (mixed signs)."""
    if signed:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.random(shape, dtype=np.float32) * 2


def bsr_inputs(num_panels=5, ph=16, k=32, n_cols=300, T=8, G=2, seed=0,
               bw=BW, signed=False):
    """A_panels, Bt, tile_panel, step_cblock; N is not a multiple of bw
    and the partial last column block is always read."""
    rng = np.random.default_rng(seed)
    A_panels = fills(rng, (num_panels, ph, k), signed)
    Bt = fills(rng, (n_cols, k), signed)
    tile_panel = rng.integers(0, num_panels, T).astype(np.int32)
    n_cb = -(-n_cols // bw)
    step_cblock = rng.integers(0, n_cb, T // G).astype(np.int32)
    step_cblock[0] = n_cb - 1
    return A_panels, Bt, tile_panel, step_cblock


def subpack_inputs(num_panels=5, ph=16, k=32, H=70, Tp=6, sw=32, seed=1,
                   bw=BW, signed=False, past_h=False):
    """A_panels, Bt, sp_colperm, sp_panel, sp_sub. ``sp_colperm`` (H,) lists
    the hot columns of Bt (3 * H rows) as the packer leaves them: distinct
    ids in no order, the last real one repeated over a pad tail, then
    trimmed, so that H is not a multiple of sw; the partial last sub-block
    is always read. With ``past_h`` one slot names a sub-block wholly past
    H."""
    rng = np.random.default_rng(seed)
    S = bw // sw
    A_panels = fills(rng, (num_panels, ph, k), signed)
    Bt = fills(rng, (3 * H, k), signed)
    sp_colperm = rng.permutation(3 * H)[:H].astype(np.int32)
    sp_colperm[-5:] = sp_colperm[-6]
    sp_panel = rng.integers(0, num_panels, Tp).astype(np.int32)
    n_sb = -(-H // sw)
    sp_sub = rng.integers(0, n_sb, (Tp, S)).astype(np.int32)
    sp_sub[0, -1] = n_sb - 1
    if past_h:
        sp_sub[1, 0] = n_sb
    return A_panels, Bt, sp_colperm, sp_panel, sp_sub


def gathered_inputs(num_panels=5, ph=16, k=32, n_cols=300, T=6, seed=2,
                    out_of_range=False, bw=BW, signed=False):
    """A_panels, Bt, panel, cols (T, bw): column ids unsorted, repeated
    (the last tile repeats one column, as pad tiles do) and, with
    ``out_of_range``, one id -1 and one id N."""
    rng = np.random.default_rng(seed)
    A_panels = fills(rng, (num_panels, ph, k), signed)
    Bt = fills(rng, (n_cols, k), signed)
    panel = rng.integers(0, num_panels, T).astype(np.int32)
    cols = rng.integers(0, n_cols, (T, bw)).astype(np.int32)
    cols[0, 0] = n_cols - 1
    cols[-1] = cols[-1, 0]
    if out_of_range:
        cols[0, 1], cols[T // 2, 5] = -1, n_cols
    return A_panels, Bt, panel, cols


def tensors(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def pallas():
    """The JAX package's Pallas kernel factories and jax.numpy, imported
    here so that the module imports without JAX."""
    import jax.numpy as jnp
    from bsmr_sddmm_tpu.ops import pallas_dense
    return jnp, pallas_dense


def assert_matches(ref, got, precision):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape
    if precision == "highest":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        res = check_data(ref, got)
        assert res.passed, str(res)


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels (CPU, interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("ph,k", [(16, 32), (32, 64)])
@pytest.mark.parametrize("G", [2, 4])
def test_bsr_dense_plain_matches_fat_kernel(precision, ph, k, G):
    jnp, pd = pallas()
    A_panels, Bt, tile_panel, step_cblock = bsr_inputs(ph=ph, k=k, G=G)
    ref = pd.make_bsr_fat_kernel(
        num_panels=A_panels.shape[0], ph=ph, bw=BW, k=k,
        n_cols=Bt.shape[0], fat_group=G, precision=precision,
        interpret=True)(jnp.asarray(A_panels), jnp.asarray(Bt),
                        jnp.asarray(tile_panel), jnp.asarray(step_cblock))
    got = dk.bsr_dense_plain(*tensors(A_panels, Bt, tile_panel, step_cblock),
                             fat_group=G, block_width=BW,
                             passes=PRECISION[precision][0])
    assert_matches(ref, got.numpy(), precision)


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("ph,k", [(16, 32), (32, 64)])
def test_bsr_dense_plain_matches_dense_kernel(precision, ph, k):
    jnp, pd = pallas()
    A_panels, Bt, tile_panel, tile_cblock = bsr_inputs(ph=ph, k=k, G=1)
    ref = pd.make_bsr_dense_kernel(
        num_panels=A_panels.shape[0], ph=ph, bw=BW, k=k,
        n_cols=Bt.shape[0], precision=precision,
        interpret=True)(jnp.asarray(A_panels), jnp.asarray(Bt),
                        jnp.asarray(tile_panel), jnp.asarray(tile_cblock))
    got = dk.bsr_dense_plain(*tensors(A_panels, Bt, tile_panel, tile_cblock),
                             fat_group=1, block_width=BW,
                             passes=PRECISION[precision][0])
    assert_matches(ref, got.numpy(), precision)


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("ph,k,sw", [(16, 32, 32), (32, 64, 32),
                                     (16, 32, 64)])
def test_subpack_plain_matches_subpack_kernel(precision, ph, k, sw):
    """The Pallas kernel takes Bt2 = Bt[sp_colperm] gathered outside it, as
    the JAX body feeds it; the port's side takes Bt and sp_colperm."""
    jnp, pd = pallas()
    A_panels, Bt, sp_colperm, sp_panel, sp_sub = subpack_inputs(ph=ph, k=k,
                                                                sw=sw)
    Bt2 = Bt[sp_colperm]
    ref = pd.make_subpack_kernel(
        num_panels=A_panels.shape[0], ph=ph, bw=BW, k=k,
        n_cols=Bt2.shape[0], sw=sw, precision=precision,
        interpret=True)(jnp.asarray(A_panels), jnp.asarray(Bt2),
                        jnp.asarray(sp_panel), jnp.asarray(sp_sub))
    got = dk.subpack_plain(*tensors(A_panels, Bt, sp_colperm, sp_panel,
                                    sp_sub), subblock_width=sw,
                           passes=PRECISION[precision][0])
    assert_matches(ref, got.numpy(), precision)


@pytest.mark.parametrize("sw,bw", [(32, 128), (64, 128), (32, 256)])
def test_subpack_plain_reads_past_h_as_zero(sw, bw):
    """Against numpy: the permutation's repeats, the partial last sub-block
    and a sub-block wholly past H (zeros)."""
    A_panels, Bt, sp_colperm, sp_panel, sp_sub = subpack_inputs(
        sw=sw, bw=bw, past_h=True, signed=True)
    got = dk.subpack_plain(*tensors(A_panels, Bt, sp_colperm, sp_panel,
                                    sp_sub), subblock_width=sw).numpy()
    H, n_sb = sp_colperm.shape[0], -(-sp_colperm.shape[0] // sw)
    Bt2 = np.zeros(((n_sb + 1) * sw, Bt.shape[1]), np.float32)
    Bt2[:H] = Bt[sp_colperm]
    rows = (sp_sub[:, :, None] * sw + np.arange(sw)).reshape(len(sp_sub), bw)
    want = np.einsum("tpk,tck->tpc", A_panels[sp_panel], Bt2[rows])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[1, :, :sw].any()
    assert not got[0, :, bw - sw + H % sw:].any() and got[0].any()


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("ph,k", [(16, 32), (32, 64)])
def test_dense_tile_plain_matches_dense_tile_kernel(precision, ph, k):
    """make_dense_tile_kernel takes B tiles gathered outside the kernel, as
    the JAX body feeds it (jnp.take(Bt, tile_cols))."""
    jnp, pd = pallas()
    A_panels, Bt, tile_panel, tile_cols = gathered_inputs(ph=ph, k=k)
    T = tile_panel.shape[0]
    b_tiles = jnp.take(jnp.asarray(Bt), jnp.asarray(tile_cols.reshape(-1)),
                       axis=0).reshape(T, BW, k)
    ref = pd.make_dense_tile_kernel(
        num_panels=A_panels.shape[0], ph=ph, bw=BW, k=k, chunk=T,
        precision=precision, interpret=True)(
            jnp.asarray(A_panels), b_tiles, jnp.asarray(tile_panel))
    got = dk.dense_tile_plain(*tensors(A_panels, Bt, tile_panel, tile_cols),
                              passes=PRECISION[precision][0])
    assert_matches(ref, got.numpy(), precision)


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("ph,k", [(16, 32), (32, 64)])
def test_fused_gathered_plain_matches_fused_kernel(precision, ph, k):
    jnp, pd = pallas()
    A_panels, Bt, g_panel, g_cols = gathered_inputs(ph=ph, k=k, seed=3)
    ref = pd.make_fused_gathered_kernel(
        num_panels=A_panels.shape[0], ph=ph, bw=BW, k=k,
        precision=precision, interpret=True)(
            jnp.asarray(A_panels), jnp.asarray(Bt), jnp.asarray(g_panel),
            jnp.asarray(g_cols.reshape(-1)))
    got = dk.fused_gathered_plain(*tensors(A_panels, Bt, g_panel, g_cols),
                                  passes=PRECISION[precision][0])
    assert_matches(ref, got.numpy(), precision)


def test_gathered_plain_reads_out_of_range_ids_as_zero():
    A_panels, Bt, panel, cols = gathered_inputs(out_of_range=True)
    got = dk.gathered_tile_plain(*tensors(A_panels, Bt, panel, cols))
    n = Bt.shape[0]
    Bt_zero = np.concatenate([Bt, np.zeros((1, Bt.shape[1]), np.float32)])
    ids = np.where((cols >= 0) & (cols < n), cols, n)
    want = np.einsum("tpk,tck->tpc", A_panels[panel], Bt_zero[ids])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got[0, :, 1] == 0).all() and (got[3, :, 5] == 0).all()


def plain_case(name, signed, **kw):
    """(plain version, its operands, its keywords) of one tile kernel at
    the small shapes of the input functions above."""
    if name.startswith("bsr_dense"):
        G = int(name.split("G=")[1])
        return (dk.bsr_dense_plain,
                tensors(*bsr_inputs(G=G, signed=signed, **kw)),
                dict(fat_group=G, block_width=BW))
    if name == "subpack":
        return (dk.subpack_plain,
                tensors(*subpack_inputs(signed=signed, past_h=True, **kw)),
                dict(subblock_width=32))
    plain = dict(dense_tile=dk.dense_tile_plain,
                 fused_gathered=dk.fused_gathered_plain)[name]
    return plain, tensors(*gathered_inputs(signed=signed,
                                           out_of_range=True, **kw)), {}


PLAIN_CASES = ("bsr_dense G=1", "bsr_dense G=2", "subpack", "dense_tile",
               "fused_gathered")


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("name", PLAIN_CASES)
def test_one_pass_plain_is_fp32_product_of_hi_operands(name, signed):
    """passes=1: the fp32 product of tf32_split's hi of both operands (what
    one MMA pass computes, its products exact), not the fp32 product of
    the operands themselves; within TF32 rounding of the fp64 product."""
    plain, args, kw = plain_case(name, signed)
    hi = [dk.tf32_split(args[0])[0], dk.tf32_split(args[1])[0]] + args[2:]
    got = plain(*args, passes=1, **kw)
    torch.testing.assert_close(got, plain(*hi, passes=3, **kw), rtol=1e-6,
                               atol=0)
    three = plain(*args, passes=3, **kw)
    assert not torch.equal(got, three)
    bound = plain(args[0].abs(), args[1].abs(), *args[2:], **kw).double()
    assert ((got.double() - three.double()).abs()
            <= 2.0 ** -10 * bound + 1e-6).all()


# ---------------------------------------------------------------------------
# the wrappers' contract (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16])
def test_wrappers_take_plain_version_on_cpu(out_dtype):
    """CPU tensors go to the plain version, and no launch is counted."""
    before = (dk.bsr_dense.launches, dk.subpack.launches)
    args = tensors(*bsr_inputs(G=2))
    got = dk.bsr_dense(*args, fat_group=2, block_width=BW,
                       out_dtype=out_dtype)
    want = dk.bsr_dense_plain(*args, fat_group=2, block_width=BW,
                              out_dtype=out_dtype)
    assert got.dtype == out_dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    args = tensors(*subpack_inputs())
    got = dk.subpack(*args, subblock_width=32, out_dtype=out_dtype)
    want = dk.subpack_plain(*args, subblock_width=32, out_dtype=out_dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (dk.bsr_dense.launches, dk.subpack.launches) == before


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16])
def test_gathered_wrappers_take_plain_version_on_cpu(out_dtype):
    before = (dk.dense_tile.launches, dk.fused_gathered.launches)
    args = tensors(*gathered_inputs(out_of_range=True))
    want = dk.gathered_tile_plain(*args, out_dtype=out_dtype)
    for wrapper in (dk.dense_tile, dk.fused_gathered):
        got = wrapper(*args, out_dtype=out_dtype)
        assert got.dtype == out_dtype and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (dk.dense_tile.launches, dk.fused_gathered.launches) == before


def test_gathered_wrappers_reject_bad_inputs():
    A, Bt, panel, cols = tensors(*gathered_inputs())
    for wrapper in (dk.dense_tile, dk.fused_gathered):
        with pytest.raises(ValueError, match="int32"):
            wrapper(A, Bt, panel, cols.long())
        with pytest.raises(ValueError, match=r"\(T, bw\)"):
            wrapper(A, Bt, panel[:-1], cols)
        with pytest.raises(ValueError, match=r"\(T, bw\)"):
            wrapper(A, Bt, panel, cols.reshape(-1))
        with pytest.raises(ValueError, match="float32"):
            wrapper(A, Bt.half(), panel, cols)
        with pytest.raises(ValueError, match="CUDA or CPU"):
            wrapper(A.to("meta"), Bt.to("meta"), panel.to("meta"),
                    cols.to("meta"))


def test_wrappers_reject_bad_inputs():
    A, Bt, tp, sc = tensors(*bsr_inputs(G=2))
    kw = dict(fat_group=2, block_width=BW)
    with pytest.raises(ValueError, match="int32"):
        dk.bsr_dense(A, Bt, tp.long(), sc, **kw)
    with pytest.raises(ValueError, match="float32"):
        dk.bsr_dense(A.double(), Bt, tp, sc, **kw)
    with pytest.raises(ValueError, match="T/G"):
        dk.bsr_dense(A, Bt, tp, sc[:-1], **kw)
    with pytest.raises(ValueError, match="out_dtype"):
        dk.bsr_dense(A, Bt, tp, sc, out_dtype=torch.bfloat16, **kw)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        dk.bsr_dense(A.to("meta"), Bt.to("meta"), tp.to("meta"),
                     sc.to("meta"), **kw)
    A, Bt, cp, sp, ss = tensors(*subpack_inputs())
    with pytest.raises(ValueError, match="sp_sub"):
        dk.subpack(A, Bt, cp, sp[:-1], ss, subblock_width=32)
    with pytest.raises(ValueError, match="sp_colperm"):
        dk.subpack(A, Bt, cp.reshape(-1, 1), sp, ss, subblock_width=32)
    with pytest.raises(ValueError, match="int32"):
        dk.subpack(A, Bt, cp.long(), sp, ss, subblock_width=32)
    with pytest.raises(ValueError, match="on cpu"):
        dk.subpack(A, Bt.to("meta"), cp, sp, ss, subblock_width=32)


@pytest.mark.parametrize("passes", [0, 2, 6])
def test_wrappers_reject_a_pass_count_other_than_1_or_3(passes):
    A, Bt, tp, sc = tensors(*bsr_inputs(G=2))
    with pytest.raises(ValueError, match="passes must be 1 or 3"):
        dk.bsr_dense(A, Bt, tp, sc, fat_group=2, block_width=BW,
                     passes=passes)
    A, Bt, cp, sp, ss = tensors(*subpack_inputs())
    with pytest.raises(ValueError, match="passes must be 1 or 3"):
        dk.subpack(A, Bt, cp, sp, ss, subblock_width=32, passes=passes)
    A, Bt, panel, cols = tensors(*gathered_inputs())
    for wrapper in (dk.dense_tile, dk.fused_gathered):
        with pytest.raises(ValueError, match="passes must be 1 or 3"):
            wrapper(A, Bt, panel, cols, passes=passes)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc means an error, never a silent fallback."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("BSMR_TORCH_KERNEL_DIR", str(tmp_path / "kernels"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()


def test_build_path_keys_sources_and_flags(monkeypatch, tmp_path):
    monkeypatch.setenv("BSMR_TORCH_KERNEL_DIR", str(tmp_path))
    path = _build.library_path()
    assert path.startswith(str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.library_path() != path
    monkeypatch.delenv("BSMR_TORCH_KERNEL_DIR")
    assert _build.kernel_dir().endswith(("build/torch_kernels"))


@pytest.mark.parametrize("variant", sorted(subpack_phases.VARIANTS))
def test_phase_variants_edit_the_sources_they_name(variant, tmp_path):
    """Each variant of ops/subpack_phases.py is the kernel sources with its
    edits, every edit found exactly once (or the copy raises), and nothing
    else changed; the sources themselves hold no switch."""
    csrc = subpack_phases.copy_variant(variant, str(tmp_path))
    edited = {fname for fname, _, _ in subpack_phases.VARIANTS[variant]}
    assert edited <= set(_build.SOURCES + _build.HEADERS)
    for fname in _build.SOURCES + _build.HEADERS:
        with open(f"{csrc}/{fname}") as f, \
                open(f"{_build._CSRC}/{fname}") as g:
            assert (f.read() != g.read()) == (fname in edited)


# ---------------------------------------------------------------------------
# work and bound of a launch; the three-pass TF32 product (CPU)
# ---------------------------------------------------------------------------

#: banded_mesh_32k plans (M = N = 32768 rows of A and of Bt referenced):
#: (T, K, index bytes) -> (MB moved, bound ms, the side that binds)
WORK_TABLE = {
    "bsr_dense K=128 G=32": ((9216, 128, 4 * (9216 + 288)),
                             (184.6, 0.059, "operations")),
    "bsr_dense K=32 G=32": ((9216, 32, 4 * (9216 + 288)),
                            (159.4, 0.048, "bytes")),
    "bsr_dense K=128 G=1": ((7168, 128, 0), (151.0, 0.046, "operations")),
    "dense_tile K=128 reorder": ((3584, 128, 4 * 3584 * 129),
                                 (94.1, 0.028, "bytes")),
    "fused_gathered K=128 reorder": ((2048, 128, 4 * 2048 * 129),
                                     (68.2, 0.020, "bytes")),
}


@pytest.mark.parametrize("row", sorted(WORK_TABLE))
def test_tile_work_matches_table(row):
    (T, k, index_bytes), (mb, bound_ms, side) = WORK_TABLE[row]
    w = dk.tile_work(T, 32, 128, k, torch.float32, a_rows=32768,
                     b_rows=32768, index_bytes=index_bytes)
    assert w["flops"] == 2 * T * 32 * 128 * k
    assert round(w["bytes"] / 1e6, 1) == mb
    assert round(w["bound_ms"], 3) == bound_ms
    assert w["bound_ms"] == max(w["bytes_ms"], w["ops_ms"])
    assert w["ops_ms"] == pytest.approx(3 * w["flops"] / 495e12 * 1e3)
    assert w["bytes_ms"] == pytest.approx(w["bytes"] / 3.35e12 * 1e3)
    if side:
        assert w["bound_by"] == side


def test_tile_work_fp16_halves_the_output_bytes():
    kw = dict(a_rows=32768, b_rows=32768, index_bytes=0)
    w32 = dk.tile_work(9216, 32, 128, 32, torch.float32, **kw)
    w16 = dk.tile_work(9216, 32, 128, 32, torch.float16, **kw)
    assert w16["out_bytes"] * 2 == w32["out_bytes"] == 9216 * 32 * 128 * 4
    assert w32["bytes"] - w16["bytes"] == w16["out_bytes"]
    assert w16["flops"] == w32["flops"] and w16["bound_ms"] < w32["bound_ms"]


@pytest.mark.parametrize("row", sorted(WORK_TABLE))
def test_tile_work_one_pass_is_a_third_of_the_operations(row):
    (T, k, index_bytes), _ = WORK_TABLE[row]
    kw = dict(a_rows=32768, b_rows=32768, index_bytes=index_bytes)
    one = dk.tile_work(T, 32, 128, k, torch.float32, passes=1, **kw)
    three = dk.tile_work(T, 32, 128, k, torch.float32, **kw)
    assert one["ops_ms"] == pytest.approx(three["ops_ms"] / 3)
    assert one["bytes"] == three["bytes"] and one["flops"] == three["flops"]
    assert one["bound_ms"] == max(one["bytes_ms"], one["ops_ms"])


@pytest.mark.parametrize("signed", [False, True])
def test_tf32_split_restores_the_value(signed):
    """hi and lo are TF32 values (13 low bits clear), hi is x rounded to
    nearest, and hi + lo restores x to 2^-21 relative."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(fills(rng, 100_000, signed))
    hi, lo = dk.tf32_split(x)
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert not (part.view(torch.int32) & 0x1FFF).any()
    x64, hi64, lo64 = x.double(), hi.double(), lo.double()
    assert ((x64 - hi64).abs() <= x64.abs() * 2.0 ** -11).all()
    assert ((hi64 + lo64 - x64).abs() <= x64.abs() * 2.0 ** -21).all()
    # a value that is TF32 already splits into itself and zero
    hi2, lo2 = dk.tf32_split(hi)
    assert torch.equal(hi2, hi) and not lo2.any()


@pytest.mark.parametrize("k", [32, 64, 128, 256])
def test_three_pass_product_keeps_fp32_accuracy(k):
    """On the reference's fills the kernels' arithmetic is within rel 1e-5
    of the fp64 product: check_data's rel 1e-3 holds with margin."""
    A = bt.make_dense(96, k, seed=1337)
    Bt = bt.make_dense(k, 160, seed=1338).T.copy()
    got = dk.three_pass_matmul(torch.from_numpy(A), torch.from_numpy(Bt))
    want = A.astype(np.float64) @ Bt.astype(np.float64).T
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-5, atol=0)
    assert check_data(want, got.numpy()).passed


@pytest.mark.parametrize("k", [32, 64, 128, 256])
def test_three_pass_product_with_mixed_signs(k):
    rng = np.random.default_rng(k)
    A = fills(rng, (96, k), signed=True)
    Bt = fills(rng, (160, k), signed=True)
    got = dk.three_pass_matmul(torch.from_numpy(A), torch.from_numpy(Bt))
    want = A.astype(np.float64) @ Bt.astype(np.float64).T
    bound = np.abs(A).astype(np.float64) @ np.abs(Bt).astype(np.float64).T
    assert (np.abs(got.double().numpy() - want) <= 1e-5 * bound).all()
    # one TF32 pass alone does not meet that bound
    hi_a, _ = dk.tf32_split(torch.from_numpy(A))
    hi_b, _ = dk.tf32_split(torch.from_numpy(Bt))
    one = (hi_a @ hi_b.T).double().numpy()
    assert not (np.abs(one - want) <= 1e-5 * bound).all()


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("k", [32, 128])
def test_three_pass_product_matches_subpack_plain(k, signed):
    """The packed tier's shapes (ph 32, S = 4 sub-blocks of 32 hot columns):
    the arithmetic of the subpack kernel, stated in plain torch on the rows
    it resolves, agrees with subpack_plain as the kernel is held to on the
    card."""
    A_panels, Bt, sp_colperm, sp_panel, sp_sub = subpack_inputs(
        num_panels=12, ph=32, k=k, H=200, Tp=16, signed=signed, past_h=True)
    args = tensors(A_panels, Bt, sp_colperm, sp_panel, sp_sub)
    want = dk.subpack_plain(*args, subblock_width=32)
    H = sp_colperm.shape[0]
    rows = (sp_sub[:, :, None] * 32 + np.arange(32)).reshape(len(sp_sub), BW)
    Bt2 = np.zeros((rows.max() + 1, k), np.float32)
    Bt2[:H] = Bt[sp_colperm]
    a, b = tensors(A_panels[sp_panel], Bt2[rows])
    got = dk.three_pass_matmul(a, b)
    assert got.shape == want.shape == (16, 32, BW)
    if signed:
        bound = a.abs() @ b.abs().transpose(1, 2)
        assert ((got - want).abs() <= 1e-5 * bound).all()
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert not got[1, :, :32].any()


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (card only)
# ---------------------------------------------------------------------------

def assert_kernel_close(got, want):
    if got.dtype == torch.float16:
        res = check_data(want.float().cpu().numpy(), got.float().cpu().numpy())
        assert res.passed, str(res)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("ph,k,G", [(32, 128, 32), (32, 32, 16),
                                    (32, 128, 1), (16, 32, 2),
                                    (64, 256, 4)])
def test_bsr_dense_kernel_matches_plain(cuda, out_dtype, ph, k, G):
    args = tensors(*bsr_inputs(num_panels=40, ph=ph, k=k, n_cols=1000,
                               T=64, G=G), device=cuda)
    before = dk.bsr_dense.launches
    got = dk.bsr_dense(*args, fat_group=G, block_width=BW,
                       out_dtype=out_dtype)
    want = dk.bsr_dense_plain(*args, fat_group=G, block_width=BW,
                              out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert dk.bsr_dense.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (64, ph, BW)
    assert_kernel_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("ph,k,sw", [(32, 128, 32), (32, 32, 32),
                                     (16, 64, 64)])
def test_subpack_kernel_matches_plain(cuda, out_dtype, ph, k, sw):
    args = tensors(*subpack_inputs(num_panels=40, ph=ph, k=k, H=1000,
                                   Tp=64, sw=sw), device=cuda)
    before = dk.subpack.launches
    got = dk.subpack(*args, subblock_width=sw, out_dtype=out_dtype)
    want = dk.subpack_plain(*args, subblock_width=sw, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert dk.subpack.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (64, ph, BW)
    assert_kernel_close(got, want)


GATHERED = {"dense_tile": (dk.dense_tile, dk.dense_tile_plain),
            "fused_gathered": (dk.fused_gathered, dk.fused_gathered_plain)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GATHERED))
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("ph,k", [(32, 128), (32, 32), (16, 64), (64, 256)])
def test_gathered_kernels_match_plain(cuda, name, out_dtype, ph, k):
    """Ragged N (not a multiple of bw), unsorted and repeated column ids,
    one id -1 and one id N."""
    wrapper, plain = GATHERED[name]
    args = tensors(*gathered_inputs(num_panels=40, ph=ph, k=k, n_cols=1000,
                                    T=64, out_of_range=True), device=cuda)
    before = wrapper.launches
    got = wrapper(*args, out_dtype=out_dtype)
    want = plain(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (64, ph, BW)
    assert_kernel_close(got, want)
    assert (got[0, :, 1] == 0).all() and (got[32, :, 5] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GATHERED))
def test_gathered_zero_tiles_launch_nothing(cuda, name):
    wrapper, _ = GATHERED[name]
    A, Bt, _, _ = tensors(*gathered_inputs(), device=cuda)
    panel = torch.zeros(0, dtype=torch.int32, device=cuda)
    cols = torch.zeros((0, BW), dtype=torch.int32, device=cuda)
    before = wrapper.launches
    out = wrapper(A, Bt, panel, cols)
    assert out.shape == (0, A.shape[1], BW)
    assert wrapper.launches == before


@pytest.mark.cuda
def test_zero_tiles_launch_nothing(cuda):
    A, Bt, _, _ = tensors(*bsr_inputs(), device=cuda)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = dk.bsr_dense.launches
    out = dk.bsr_dense(A, Bt, empty, empty, fat_group=1, block_width=BW)
    assert out.shape == (0, A.shape[1], BW)
    assert dk.bsr_dense.launches == before


@pytest.mark.cuda
def test_kernel_rejects_unsupported_tile(cuda):
    A, Bt, tp, sc = tensors(*bsr_inputs(ph=24), device=cuda)
    with pytest.raises(ValueError, match="no kernel"):
        dk.bsr_dense(A, Bt, tp, sc, fat_group=2, block_width=BW)


# ---------------------------------------------------------------------------
# the tensor-core kernels' edges (card only): mixed signs, odd K, ragged N,
# ids out of range, runs of a fat step, sub-blocks past H, every geometry,
# more tiles than resident blocks, repeatability
# ---------------------------------------------------------------------------

def assert_within_products(got, plain, args, kw):
    """|kernel - plain| <= 1e-5 * (|A| . |B|^T) elementwise, where the
    bound is the plain version on the operands' absolute values; for fp16
    output plus one fp16 ulp of the plain value."""
    want = plain(*args, **kw)
    bound = plain(args[0].abs(), args[1].abs(), *args[2:],
                  **dict(kw, out_dtype=torch.float32))
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    slack = 1e-5 * bound
    if got.dtype == torch.float16:
        slack = slack + 2.0 ** -10 * want.float().abs() + 6e-8
    assert ((got.float() - want.float()).abs() <= slack).all()


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 3, 12, 16, 32])
@pytest.mark.parametrize("k", [32, 36, 33, 40, 256])
def test_bsr_dense_kernel_edges(cuda, k, G):
    """Mixed signs; K with and without 16-byte rows and a ragged last
    chunk; N not a multiple of bw; fat steps worked two tiles at a time,
    with a lone last tile (G = 3); K = 256 does not stay resident."""
    args = tensors(*bsr_inputs(num_panels=50, ph=32, k=k, n_cols=1000,
                               T=3 * G, G=G, signed=True), device=cuda)
    kw = dict(fat_group=G, block_width=BW, out_dtype=torch.float32)
    got = dk.bsr_dense(*args, **kw)
    assert_within_products(got, dk.bsr_dense_plain, args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("k,G", [(64, 8), (128, 5), (32, 32)])
def test_bsr_dense_kernel_shares_of_many_units(cuda, k, G):
    """More units than thread blocks the card holds: every persistent
    block walks several units and crosses fat steps, reloading the
    resident column block."""
    args = tensors(*bsr_inputs(num_panels=300, ph=32, k=k, n_cols=5000,
                               T=512 * G, G=G, signed=True), device=cuda)
    kw = dict(fat_group=G, block_width=BW, out_dtype=torch.float32)
    got = dk.bsr_dense(*args, **kw)
    assert_within_products(got, dk.bsr_dense_plain, args, kw)
    assert torch.equal(dk.bsr_dense(*args, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("ph,bw", sorted(dk.GEOMETRIES))
@pytest.mark.parametrize("k,G", [(128, 4), (64, 1), (64, 4), (32, 3)])
def test_bsr_dense_kernel_every_geometry(cuda, k, G, ph, bw, out_dtype):
    """(64, 4) and (32, 3) keep the column block resident at both block
    widths (at 256 on the wider warpgroup MMA), the second with a ragged
    last unit; (128, 4) does so at width 128 and streams at 256; G = 1
    streams."""
    args = tensors(*bsr_inputs(num_panels=20, ph=ph, k=k, n_cols=1000,
                               T=24, G=G, bw=bw, signed=True), device=cuda)
    kw = dict(fat_group=G, block_width=bw, out_dtype=out_dtype)
    got = dk.bsr_dense(*args, **kw)
    assert got.shape == (24, ph, bw)
    assert_within_products(got, dk.bsr_dense_plain, args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GATHERED))
@pytest.mark.parametrize("k", [32, 36, 33, 40, 256])
def test_gathered_kernel_edges(cuda, name, k):
    """Mixed signs, repeated ids, one id -1 and one id N, odd K."""
    wrapper, plain = GATHERED[name]
    args = tensors(*gathered_inputs(num_panels=50, ph=32, k=k, n_cols=1000,
                                    T=40, out_of_range=True, signed=True),
                   device=cuda)
    kw = dict(out_dtype=torch.float32)
    got = wrapper(*args, **kw)
    assert_within_products(got, plain, args, kw)
    assert (got[0, :, 1] == 0).all() and (got[20, :, 5] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("ph,bw", sorted(dk.GEOMETRIES))
def test_gathered_kernel_every_geometry(cuda, ph, bw, out_dtype):
    args = tensors(*gathered_inputs(num_panels=20, ph=ph, k=64, n_cols=1000,
                                    T=24, bw=bw, out_of_range=True,
                                    signed=True), device=cuda)
    kw = dict(out_dtype=out_dtype)
    got = dk.dense_tile(*args, **kw)
    assert got.shape == (24, ph, bw)
    assert_within_products(got, dk.dense_tile_plain, args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 36, 33, 40, 256])
def test_subpack_kernel_edges(cuda, k):
    """Mixed signs; K with and without 16-byte rows and a ragged last
    chunk; a permutation with repeats; the partial last sub-block and a
    sub-block wholly past H read as zero."""
    args = tensors(*subpack_inputs(num_panels=50, ph=32, k=k, H=1000, Tp=40,
                                   signed=True, past_h=True), device=cuda)
    kw = dict(subblock_width=32, out_dtype=torch.float32)
    got = dk.subpack(*args, **kw)
    assert_within_products(got, dk.subpack_plain, args, kw)
    assert not got[1, :, :32].any()
    assert not got[0, :, 96 + 1000 % 32:].any() and got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("ph,bw", sorted(dk.GEOMETRIES))
@pytest.mark.parametrize("sw", [32, 64])
def test_subpack_kernel_every_geometry(cuda, sw, ph, bw, out_dtype):
    args = tensors(*subpack_inputs(num_panels=20, ph=ph, k=64, H=1000, Tp=24,
                                   sw=sw, bw=bw, signed=True, past_h=True),
                   device=cuda)
    kw = dict(subblock_width=sw, out_dtype=out_dtype)
    got = dk.subpack(*args, **kw)
    assert got.shape == (24, ph, bw)
    assert_within_products(got, dk.subpack_plain, args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("k,Tp", [(128, 4096), (32, 6000)])
def test_subpack_kernel_more_tiles_than_resident_blocks(cuda, k, Tp):
    """More tiles than the thread blocks the card holds at once."""
    args = tensors(*subpack_inputs(num_panels=300, ph=32, k=k, H=5000,
                                   Tp=Tp, signed=True), device=cuda)
    kw = dict(subblock_width=32, out_dtype=torch.float32)
    got = dk.subpack(*args, **kw)
    assert_within_products(got, dk.subpack_plain, args, kw)
    assert torch.equal(dk.subpack(*args, **kw), got)


@pytest.mark.cuda
def test_subpack_zero_tiles_launch_nothing(cuda):
    A, Bt, cp, _, _ = tensors(*subpack_inputs(), device=cuda)
    sp_panel = torch.zeros(0, dtype=torch.int32, device=cuda)
    sp_sub = torch.zeros((0, 4), dtype=torch.int32, device=cuda)
    before = dk.subpack.launches
    out = dk.subpack(A, Bt, cp, sp_panel, sp_sub, subblock_width=32)
    assert out.shape == (0, A.shape[1], BW)
    assert dk.subpack.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bsr_dense G=32", "bsr_dense G=1",
                                  "subpack", "dense_tile", "fused_gathered"])
def test_kernels_repeat_bit_for_bit(cuda, case):
    if case == "subpack":
        args = tensors(*subpack_inputs(num_panels=40, ph=32, k=128, H=1000,
                                       Tp=64, signed=True), device=cuda)

        def run():
            return dk.subpack(*args, subblock_width=32)
    elif case.startswith("bsr_dense"):
        G = int(case.split("=")[1])
        args = tensors(*bsr_inputs(num_panels=40, ph=32, k=128, n_cols=1000,
                                   T=64, G=G, signed=True), device=cuda)

        def run():
            return dk.bsr_dense(*args, fat_group=G, block_width=BW)
    else:
        args = tensors(*gathered_inputs(num_panels=40, ph=32, k=128,
                                        n_cols=1000, T=64, signed=True),
                       device=cuda)

        def run():
            return GATHERED[case][0](*args)
    first = run()
    for _ in range(3):
        assert torch.equal(run(), first)


def small_plan(out_dtype="float32"):
    csr = random_mask(**SMALL)
    cfg = bt.SddmmConfig(**dict(BASE_CFG, out_dtype=out_dtype))
    return csr, cfg, bt.pack_tiles(csr, bt.BsmrSddmm(csr, cfg).reorder(), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "float16"])
def test_body_on_cuda_matches_cpu(cuda, out_dtype):
    """The body with both kernels on the card against the plain body on
    the CPU and the fp64 oracle."""
    csr, cfg, plan = small_plan(out_dtype)
    assert plan.fat_group > 1 and plan.num_packed > 0
    A = bt.make_dense(csr.rows, cfg.k, seed=5)
    Bt = bt.make_dense(csr.cols, cfg.k, seed=6)
    before = (dk.bsr_dense.launches, dk.subpack.launches)
    got = make_sddmm_body(plan, cfg)(
        torch.from_numpy(A).to(cuda), torch.from_numpy(Bt).to(cuda),
        device_plan(plan, cuda)).cpu().numpy()
    assert dk.bsr_dense.launches > before[0]
    assert dk.subpack.launches > before[1]
    want = make_sddmm_body(plan, cfg)(
        torch.from_numpy(A), torch.from_numpy(Bt),
        device_plan(plan, "cpu")).numpy()
    assert check_data(want, got).passed
    assert check_data(sddmm_ref(A, Bt.T, csr), got).passed


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "float16"])
def test_reorder_fused_body_on_cuda_matches_cpu(cuda, out_dtype):
    """A reorder plan with the fused gathered tier: dense_tile, subpack and
    fused_gathered on the card against the plain body on the CPU."""
    csr = random_mask(**SMALL)
    cfg = bt.SddmmConfig(**dict(BASE_CFG, out_dtype=out_dtype, delta=0.05,
                                col_mode="reorder", gathered_backend="fused"))
    plan = bt.pack_tiles(csr, bt.BsmrSddmm(csr, cfg).reorder(), cfg)
    assert plan.num_tiles and plan.num_packed and plan.g_groups is None
    A = bt.make_dense(csr.rows, cfg.k, seed=5)
    Bt = bt.make_dense(csr.cols, cfg.k, seed=6)
    kernels = (dk.dense_tile, dk.subpack, dk.fused_gathered)
    before = [w.launches for w in kernels]
    got = make_sddmm_body(plan, cfg)(
        torch.from_numpy(A).to(cuda), torch.from_numpy(Bt).to(cuda),
        device_plan(plan, cuda)).cpu().numpy()
    assert all(w.launches > b for w, b in zip(kernels, before))
    want = make_sddmm_body(plan, cfg)(
        torch.from_numpy(A), torch.from_numpy(Bt),
        device_plan(plan, "cpu")).numpy()
    assert check_data(want, got).passed
    assert check_data(sddmm_ref(A, Bt.T, csr), got).passed


@pytest.mark.cuda
def test_benchmark_on_cuda_passes(cuda):
    csr = random_mask(**SMALL)
    A = bt.make_dense(csr.rows, 32, seed=1337)
    B = bt.make_dense(32, csr.cols, seed=1338)
    log = bt.BsmrSddmm(csr, bt.SddmmConfig(**BASE_CFG)).benchmark(
        A, B, validate=True)
    assert log.check_result == "pass"
    assert log.device == torch.cuda.get_device_name(0)
    assert log.sddmm_ms > 0


# the mask of tests/test_torch_autotune.py on which a tiled plan beats the
# dense arm and the three alphas cluster differently
AUTO = dict(rows=4096, cols=8192, nnz=30000, seed=23, block_rows=32,
            block_cols=128, block_fill=0.8, shuffle_rows=True)


@pytest.mark.cuda
def test_refine_resorts_by_measured_time(cuda):
    """refine_top on the card: the best-priced candidates are timed, the
    times join the table as ("measured", alpha, delta, subpack), and the
    pick is the measured argmin. A candidate that fails would raise."""
    csr = random_mask(**AUTO)
    cfg = bt.SddmmConfig(k=32, panel_height=16, subpack_min_nnz=12,
                         num_iterations=4)
    pipe = bt.BsmrSddmm(csr, cfg, device=cuda)
    before = dk.bsr_dense.launches
    choice = autotune.choose_config(csr, pipe._row_reordering, cfg,
                                    refine_top=4, device=cuda)
    measured = {key[1:]: ms for key, ms in choice.candidates.items()
                if isinstance(key, tuple) and key[0] == "measured"}
    assert len(measured) >= 2
    assert all(ms > 0 for ms in measured.values())
    assert measured[(choice.alpha, choice.delta, choice.subpack)] == \
        min(measured.values())
    assert dk.bsr_dense.launches > before


@pytest.mark.cuda
def test_dense_fallback_on_cuda_passes(cuda):
    csr = uniform(4096, 350_000, seed=9)
    A = bt.make_dense(csr.rows, 32, seed=1)
    B = bt.make_dense(32, csr.cols, seed=2)
    pipe = bt.BsmrSddmm(csr, bt.SddmmConfig(k=32, panel_height=16,
                                            num_iterations=2), device=cuda)
    log = pipe.benchmark(A, B, delta="dense", validate=True)
    assert log.check_result == "pass"
    assert log.extras["strategy"] == "dense_fallback"
    assert log.device == torch.cuda.get_device_name(0) and log.sddmm_ms > 0
    assert float(log.extras["sddmm_eager_ms"]) > 0   # beside the replay
    assert check_data(sddmm_ref(A, B, csr),
                      pipe.run(A, B, delta="dense")).passed


@pytest.mark.cuda
@pytest.mark.parametrize("name", baselines.BASELINE_NAMES)
def test_baseline_on_cuda_passes(cuda, name):
    csr = random_mask(**SMALL)
    A = bt.make_dense(csr.rows, 32, seed=1337)
    B = bt.make_dense(32, csr.cols, seed=1338)
    log = baselines.benchmark_baseline(name, csr, A, B, iterations=2,
                                       validate=True, device=cuda)
    assert log.check_result == "pass" and log.error_rate == 0.0


@pytest.mark.cuda
def test_time_cuda_graph_times_the_call(cuda):
    """A replayed graph of one call gives that call's output and a device
    time close to time_cuda's where the device work dominates."""
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda, time_cuda_graph
    a = torch.rand(2048, 2048, device=cuda)
    ms_graph, out = time_cuda_graph(torch.mm, a, a, iterations=20)
    ms_events, want = time_cuda(torch.mm, a, a, iterations=20)
    torch.testing.assert_close(out, want)
    assert 0.5 * ms_events < ms_graph < 2.0 * ms_events


# ---------------------------------------------------------------------------
# one TF32 pass, the two streams and the caller's TF32 flag (card only)
# ---------------------------------------------------------------------------

def card_case(name, k, device, signed=False):
    """(kernel, plain, operands on ``device``, keywords) at the shapes of
    the CUDA tests above: 64 tiles, ragged N, ids out of range."""
    if name.startswith("bsr_dense"):
        G = int(name.split("G=")[1])
        return (dk.bsr_dense, dk.bsr_dense_plain,
                tensors(*bsr_inputs(num_panels=40, ph=32, k=k, n_cols=1000,
                                    T=64, G=G, signed=signed),
                        device=device),
                dict(fat_group=G, block_width=BW))
    if name == "subpack":
        return (dk.subpack, dk.subpack_plain,
                tensors(*subpack_inputs(num_panels=40, ph=32, k=k, H=1000,
                                        Tp=64, signed=signed, past_h=True),
                        device=device), dict(subblock_width=32))
    wrapper, plain = GATHERED[name]
    return wrapper, plain, tensors(*gathered_inputs(
        num_panels=40, ph=32, k=k, n_cols=1000, T=64, out_of_range=True,
        signed=signed), device=device), {}


CARD_CASES = ("bsr_dense G=32", "bsr_dense G=1", "subpack", "dense_tile",
              "fused_gathered")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("k", [32, 128, 256])
@pytest.mark.parametrize("name", CARD_CASES)
def test_kernels_at_one_pass_match_plain(cuda, name, k, out_dtype):
    """One TF32 pass on the reference's fills (K = 256 takes bsr_dense's
    streaming route), and bit for bit from launch to launch."""
    kern, plain, args, kw = card_case(name, k, cuda)
    kw = dict(kw, out_dtype=out_dtype, passes=1)
    before = kern.launches
    got = kern(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert_kernel_close(got, want)
    assert torch.equal(kern(*args, **kw), got)
    # one pass is not the three-pass result
    assert not torch.equal(kern(*args, **dict(kw, passes=3)), got)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 33, 256])
@pytest.mark.parametrize("name", CARD_CASES)
def test_kernel_edges_at_one_pass(cuda, name, k):
    """Mixed signs, K with and without 16-byte rows: within 1e-5 *
    (|A| . |B|^T) of the plain one-pass version."""
    kern, plain, args, kw = card_case(name, k, cuda, signed=True)
    kw = dict(kw, out_dtype=torch.float32, passes=1)
    assert_within_products(kern(*args, **kw), plain, args, kw)


def card_body_case(kind, **cfg_kw):
    """(plan, config, A, Bt) of a small plan with all four tiers: the bsr
    plan of ``small_plan`` or a reorder plan with the fused gathered
    tier."""
    csr = random_mask(**SMALL)
    extra = (dict(delta=0.1, col_mode="reorder", gathered_backend="fused")
             if kind == "reorder_fused" else {})
    cfg = bt.SddmmConfig(**dict(BASE_CFG, **extra, **cfg_kw))
    plan = bt.pack_tiles(csr, bt.BsmrSddmm(csr, cfg).reorder(), cfg)
    assert plan.num_tiles and plan.num_packed and plan.num_gathered
    assert plan.num_residual
    A = torch.from_numpy(bt.make_dense(csr.rows, cfg.k, seed=5))
    Bt = torch.from_numpy(bt.make_dense(csr.cols, cfg.k, seed=6))
    return csr, plan, cfg, A, Bt


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("kind", ["bsr", "reorder_fused"])
def test_two_streams_match_one_stream(cuda, kind, precision):
    """tier_serialize "off" (the gathered tier and the residual on the
    side stream) and "auto" (on it when captured) against "on", bit for
    bit, tier by tier: eager, and each captured into a CUDA graph and
    replayed; "off" forks every call, "auto" only the captured one."""
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda_graph
    csr, plan, cfg, A, Bt = card_body_case(kind, matmul_precision=precision)
    A, Bt = A.to(cuda), Bt.to(cuda)
    dplan = device_plan(plan, cuda, emit="rphm")
    bodies = {mode: make_sddmm_body(plan, cfg.replace(tier_serialize=mode),
                                    emit="rphm")
              for mode in ("on", "off", "auto")}
    eager = {mode: body(A, Bt, dplan) for mode, body in bodies.items()}
    assert {m: b.forks for m, b in bodies.items()} == {
        "on": 0, "off": 1, "auto": 0}
    # a warm-up call, then the captured one
    replayed = {mode: time_cuda_graph(body, A, Bt, dplan, iterations=3)[1]
                for mode, body in bodies.items()}
    torch.cuda.synchronize()
    assert {m: b.forks for m, b in bodies.items()} == {
        "on": 0, "off": 3, "auto": 1}
    for outs in (eager["off"], eager["auto"], replayed["on"],
                 replayed["off"], replayed["auto"]):
        for tier, got, want in zip(TIERS, outs, eager["on"]):
            assert torch.equal(got, want), tier
    csr_out = make_sddmm_body(plan, cfg.replace(tier_serialize="off"))(
        A, Bt, device_plan(plan, cuda)).cpu().numpy()
    assert check_data(sddmm_ref(A.cpu().numpy(), Bt.cpu().numpy().T, csr),
                      csr_out).passed


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bsr", "reorder_fused"])
def test_caller_tf32_flag_moves_no_result(cuda, kind):
    """A caller's allow_tf32 = True leaves a "bf16x3" call bit for bit as
    it was, and is itself left as the caller set it; "default" runs one
    TF32 pass and still passes check_data."""
    csr, plan, cfg, A, Bt = card_body_case(kind)
    A, Bt = A.to(cuda), Bt.to(cuda)
    dplan = device_plan(plan, cuda)
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    try:
        outs = {}
        for tf32 in (False, True):
            flags.allow_tf32 = tf32
            outs[tf32] = make_sddmm_body(plan, cfg)(A, Bt, dplan)
            assert flags.allow_tf32 == tf32
        flags.allow_tf32 = False
        one = make_sddmm_body(plan, cfg.replace(
            matmul_precision="default"))(A, Bt, dplan)
        assert flags.allow_tf32 is False
    finally:
        flags.allow_tf32 = before
    assert torch.equal(outs[True], outs[False])
    assert not torch.equal(one, outs[False])
    ref = sddmm_ref(A.cpu().numpy(), Bt.cpu().numpy().T, csr)
    for out in (outs[False], one):
        assert check_data(ref, out.cpu().numpy()).passed
