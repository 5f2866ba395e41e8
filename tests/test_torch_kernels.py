"""The port's tile kernels: the plain PyTorch versions against the JAX
package's Pallas kernels (run with interpret=True, as tests/test_sddmm.py
runs them on the CPU), the wrappers' contract, and — on a CUDA device only —
the hand-written CUDA kernels against their plain versions.

Tolerances: rtol 1e-5 / atol 1e-5 against the Pallas kernels at
precision="highest" (both sides are fp32; only the order of summation
differs); the check_data tolerance (abs 1e-5 OR rel 1e-3) against the
default bf16x3 split. On the card, fp32 kernel vs fp32 plain at rtol 1e-5 /
atol 1e-4 (summation order over K <= 128 products of values below 2), and
fp16 at the check_data tolerance (each side rounds to fp16 once: at most one
fp16 ulp, rel 2^-10 < 1e-3).

The tests marked ``cuda`` import nothing of JAX, so that they run on a
machine without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels.py`` (tests/conftest.py imports jax)."""

import numpy as np
import pytest
import torch

import bsmr_sddmm_tpu_torch as bt
from bsmr_sddmm_tpu_torch.formats import random_mask
from bsmr_sddmm_tpu_torch.ops import _build
from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.ops.sddmm import (device_plan, make_sddmm_body,
                                            sddmm_ref)
from bsmr_sddmm_tpu_torch.utils.checkdata import check_data

BW = 128
SMALL = dict(rows=512, cols=768, nnz=20000, seed=7, block_rows=24,
             block_cols=96)
BASE_CFG = dict(k=32, panel_height=16, block_width=128, dense_chunk=64,
                residual_chunk=4096)


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none (decided here,
    at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the GPU run python -m pytest "
                    "--noconftest -m cuda tests/test_torch_kernels.py")
    return torch.device("cuda")


def bsr_inputs(num_panels=5, ph=16, k=32, n_cols=300, T=8, G=2, seed=0):
    """A_panels, Bt, tile_panel, step_cblock; N is not a multiple of bw
    and the partial last column block is always read."""
    rng = np.random.default_rng(seed)
    A_panels = rng.random((num_panels, ph, k), dtype=np.float32) * 2
    Bt = rng.random((n_cols, k), dtype=np.float32) * 2
    tile_panel = rng.integers(0, num_panels, T).astype(np.int32)
    n_cb = -(-n_cols // BW)
    step_cblock = rng.integers(0, n_cb, T // G).astype(np.int32)
    step_cblock[0] = n_cb - 1
    return A_panels, Bt, tile_panel, step_cblock


def subpack_inputs(num_panels=5, ph=16, k=32, H=70, Tp=6, sw=32, seed=1):
    """A_panels, Bt2, sp_panel, sp_sub; H is not a multiple of sw and the
    partial last sub-block is always read."""
    rng = np.random.default_rng(seed)
    S = BW // sw
    A_panels = rng.random((num_panels, ph, k), dtype=np.float32) * 2
    Bt2 = rng.random((H, k), dtype=np.float32) * 2
    sp_panel = rng.integers(0, num_panels, Tp).astype(np.int32)
    n_sb = -(-H // sw)
    sp_sub = rng.integers(0, n_sb, (Tp, S)).astype(np.int32)
    sp_sub[0, -1] = n_sb - 1
    return A_panels, Bt2, sp_panel, sp_sub


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

@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
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
                             fat_group=G, block_width=BW)
    assert_matches(ref, got.numpy(), precision)


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
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
                             fat_group=1, block_width=BW)
    assert_matches(ref, got.numpy(), precision)


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
@pytest.mark.parametrize("ph,k,sw", [(16, 32, 32), (32, 64, 32),
                                     (16, 32, 64)])
def test_subpack_plain_matches_subpack_kernel(precision, ph, k, sw):
    jnp, pd = pallas()
    A_panels, Bt2, sp_panel, sp_sub = subpack_inputs(ph=ph, k=k, sw=sw)
    ref = pd.make_subpack_kernel(
        num_panels=A_panels.shape[0], ph=ph, bw=BW, k=k,
        n_cols=Bt2.shape[0], sw=sw, precision=precision,
        interpret=True)(jnp.asarray(A_panels), jnp.asarray(Bt2),
                        jnp.asarray(sp_panel), jnp.asarray(sp_sub))
    got = dk.subpack_plain(*tensors(A_panels, Bt2, sp_panel, sp_sub),
                           subblock_width=sw)
    assert_matches(ref, got.numpy(), precision)


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
    A, Bt2, sp, ss = tensors(*subpack_inputs())
    with pytest.raises(ValueError, match="sp_sub"):
        dk.subpack(A, Bt2, sp[:-1], ss, subblock_width=32)
    with pytest.raises(ValueError, match="on cpu"):
        dk.subpack(A, Bt2.to("meta"), sp, ss, subblock_width=32)


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
    assert_kernel_close(got, want)


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
def test_benchmark_on_cuda_passes(cuda):
    csr = random_mask(**SMALL)
    A = bt.make_dense(csr.rows, 32, seed=1337)
    B = bt.make_dense(32, csr.cols, seed=1338)
    log = bt.BsmrSddmm(csr, bt.SddmmConfig(**BASE_CFG)).benchmark(
        A, B, validate=True)
    assert log.check_result == "pass"
    assert log.device == torch.cuda.get_device_name(0)
    assert log.sddmm_ms > 0
