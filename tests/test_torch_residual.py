"""The residual tier of the port's body (``dense_kernels.residual``,
csrc/residual.cu): the plain version against the body's former torch ops,
the wrapper's contract and work count, the body on the CPU, and — on a
CUDA device only — the kernel against the plain version, eager, on a side
stream and inside a captured CUDA graph.

On the CPU every comparison is exact (``torch.equal``): the plain version
is the same torch ops the body ran before the kernel. The kernel sums each
dot product in another order than torch's ``sum``, so on the card fp32
values are held at rtol 1e-5 + atol 1e-4 and fp16 values by ``check_data``.

The tests marked ``cuda`` import nothing of JAX, so that they run on a
machine without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_residual.py`` (tests/conftest.py imports jax)."""

import os

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (this worker's thread budget)

import bsmr_sddmm_tpu_torch as bt
from bsmr_sddmm_tpu_torch.formats import random_mask
from bsmr_sddmm_tpu_torch.ops import _build
from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.ops.sddmm import (_big_chunk, device_plan,
                                           make_sddmm_body)
from bsmr_sddmm_tpu_torch.utils import profiling
from bsmr_sddmm_tpu_torch.utils.checkdata import check_data

SMALL = dict(rows=512, cols=768, nnz=20000, seed=7, block_rows=24,
             block_cols=96)
BASE_CFG = dict(k=32, panel_height=16, block_width=128, dense_chunk=64,
                residual_chunk=4096)
DTYPES = (torch.float32, torch.float16)
#: K: the scalar path (30), partial lane groups (8, 80), one, two and
#: four 16-byte loads a lane (128, 256 with 32 lanes; 32, 64 with fewer)
KS = (8, 30, 32, 64, 80, 128, 256)
ES = (0, 1, 37, 53248)


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none (decided here,
    at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the GPU run python -m pytest "
                    "--noconftest -m cuda tests/test_torch_residual.py")
    return torch.device("cuda")


def operands(E, K, rows=300, cols=500, seed=0, offset=0, device="cpu"):
    """A_perm (rows, K), Bt (cols, K) of normal values and E int32 row ids
    of each, drawn with repeats (neighbouring ids mostly equal, as the
    packer's row-panel order leaves them), on ``device``. ``offset`` > 0
    makes both operands views that start ``offset`` floats into a buffer,
    off the 16-byte alignment."""
    rng = np.random.default_rng(seed)

    def matrix(n):
        flat = rng.standard_normal(n * K + offset).astype(np.float32)
        return torch.from_numpy(flat).to(device)[offset:].view(n, K)
    arow = np.sort(rng.integers(0, rows, E)).astype(np.int32)
    col = rng.integers(0, cols, E).astype(np.int32)
    return (matrix(rows), matrix(cols), torch.from_numpy(arow).to(device),
            torch.from_numpy(col).to(device))


def former_residual(A_perm, Bt, res_arow, res_col, out_dtype, step):
    """The body's residual before the kernel (ops/sddmm.py ``residual_out``
    as it was), ``step`` nonzeros a chunk."""
    parts = []
    for s in range(0, res_arow.shape[0], step):
        a = A_perm.index_select(0, res_arow[s:s + step])
        b = Bt.index_select(0, res_col[s:s + step])
        parts.append((a * b).sum(-1).to(out_dtype))
    if not parts:
        return A_perm.new_empty((0,), dtype=out_dtype)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def assert_residual_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want.cpu(), rtol=1e-5,
                                   atol=1e-4)
    elif got.numel():
        assert check_data(want.float().cpu().numpy(),
                          got.float().cpu().numpy()).passed


# ---------------------------------------------------------------------------
# CPU: the plain version, the wrapper's contract, the body
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [None, 64, 999, 1000])
def test_residual_plain_equals_former_torch_ops(dtype, chunk):
    """The plain version, and the wrapper on CPU tensors (no launch), give
    the former residual's bits, unchunked and in chunks that divide E and
    that do not."""
    A, Bt, arow, col = operands(1000, 32)
    want = former_residual(A, Bt, arow, col, dtype, chunk or 1000)
    before = dk.residual.launches
    for fn in (dk.residual_plain, dk.residual):
        got = fn(A, Bt, arow, col, out_dtype=dtype, chunk=chunk)
        assert got.dtype == dtype and torch.equal(got, want)
    assert dk.residual.launches == before


def test_residual_plain_of_no_nonzeros_is_empty():
    A, Bt, arow, col = operands(0, 16)
    for dtype in DTYPES:
        got = dk.residual(A, Bt, arow, col, out_dtype=dtype, chunk=8)
        assert got.shape == (0,) and got.dtype == dtype


def test_residual_rejects_bad_inputs():
    A, Bt, arow, col = operands(10, 16)
    with pytest.raises(ValueError, match="int32"):
        dk.residual(A, Bt, arow.long(), col)
    with pytest.raises(ValueError, match=r"\(rows, K\)"):
        dk.residual(A, Bt[:, :8], arow, col)
    with pytest.raises(ValueError, match="float32"):
        dk.residual(A.double(), Bt, arow, col)
    with pytest.raises(ValueError, match=r"\(E,\)"):
        dk.residual(A, Bt, arow, col[:5])
    with pytest.raises(ValueError, match="out_dtype"):
        dk.residual(A, Bt, arow, col, out_dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_work_counts_distinct_rows_index_and_values(dtype):
    """residual_work: each distinct row of either operand once, K floats;
    8 bytes of index and one value a nonzero; bound by bytes."""
    A = torch.zeros(10, 8)
    Bt = torch.zeros(20, 8)
    arow = torch.tensor([0, 0, 1, 1, 1, 9], dtype=torch.int32)
    col = torch.tensor([3, 4, 3, 5, 6, 3], dtype=torch.int32)
    work = dk.residual_work(A, Bt, arow, col, out_dtype=dtype)
    elem = torch.empty((), dtype=dtype).element_size()
    assert (work["a_rows"], work["b_rows"]) == (3, 4)
    assert work["bytes"] == 4 * 8 * (3 + 4) + 6 * (8 + elem)
    assert work["bound_ms"] == pytest.approx(
        work["bytes"] / dk.H100_BYTES_PER_S * 1e3, rel=1e-12)
    assert work["bound_by"] == "bytes"


def body_case(**cfg_kw):
    """(plan, config, A, Bt) of a small bsr plan with a residual."""
    csr = random_mask(**SMALL)
    cfg = bt.SddmmConfig(**dict(BASE_CFG, **cfg_kw))
    plan = bt.pack_tiles(csr, bt.BsmrSddmm(csr, cfg).reorder(), cfg)
    assert plan.num_residual
    A = torch.from_numpy(bt.make_dense(csr.rows, cfg.k, seed=5))
    Bt = torch.from_numpy(bt.make_dense(csr.cols, cfg.k, seed=6))
    return plan, cfg, A, Bt


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("tier_memory_mb", [512, 0])
@pytest.mark.parametrize("out_dtype", ["float32", "float16"])
def test_cpu_body_residual_is_the_former_torch_ops(backend, tier_memory_mb,
                                                   out_dtype):
    """A CPU body's residual tier, in one piece and in the row chunks of a
    tier budget of 0 MB, is the former torch ops' result bit for bit; no
    kernel launches."""
    plan, cfg, A, Bt = body_case(out_dtype=out_dtype, residual_chunk=256,
                                 tier_memory_mb=tier_memory_mb)
    dplan = device_plan(plan, "cpu", emit="rphm")
    before = dk.residual.launches
    got = make_sddmm_body(plan, cfg, backend=backend,
                          only_tier="residual")(A, Bt, dplan)
    E, k = dplan.res_arow.shape[0], cfg.k
    step = (E if E * k * 8 <= tier_memory_mb << 20
            else _big_chunk(E, cfg.residual_chunk))
    assert (step < E) == (tier_memory_mb == 0)
    A_perm = A.index_select(0, dplan.row_perm_padded)
    want = former_residual(A_perm, Bt, dplan.res_arow, dplan.res_col,
                           getattr(torch, out_dtype), step)
    assert torch.equal(got, want)
    assert dk.residual.launches == before


def test_residual_source_is_built_and_traced():
    """residual.cu compiles with the other sources (so it is in the
    library's hash), and the benchmark's trace reader counts its kernel
    as a hand kernel."""
    from benchmark import tracing
    assert "residual.cu" in _build.SOURCES
    names = tracing.hand_kernel_names(os.path.dirname(bt.__file__))
    assert "residual_dot_kernel" in names
    assert tracing.is_hand(
        "void (anonymous namespace)::residual_dot_kernel<32, true, float>("
        "float const*, float const*, int const*, int const*, float*, int, "
        "int)", names)


def test_counters_report_residual_launches(monkeypatch):
    monkeypatch.setattr(dk.residual, "launches", 13)
    assert profiling.counters()["residual.launches"] == 13


# ---------------------------------------------------------------------------
# CUDA: the kernel against the plain version, eager and captured
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E", ES)
@pytest.mark.parametrize("K", KS)
def test_residual_kernel_matches_plain(cuda, K, E, dtype):
    """Every K path (scalar, 1 to 32 lanes, one to four loads a lane) at
    E of none, one, less than a warp's step and a cell's size, repeated
    rows and columns; one launch a call where E > 0, none at E = 0, and
    the same bits from launch to launch."""
    A, Bt, arow, col = operands(E, K, seed=K + E, device=cuda)
    before = dk.residual.launches
    got = dk.residual(A, Bt, arow, col, out_dtype=dtype)
    assert dk.residual.launches == before + bool(E)
    want = dk.residual_plain(A, Bt, arow, col, out_dtype=dtype)
    torch.cuda.synchronize()
    assert_residual_close(got, want)
    assert torch.equal(dk.residual(A, Bt, arow, col, out_dtype=dtype), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [32, 128, 256])
def test_residual_kernel_on_misaligned_operands(cuda, K, dtype):
    """Operands that start 4 bytes off the 16-byte alignment take the
    scalar path at a K that would take the vector one."""
    A, Bt, arow, col = operands(4099, K, offset=1, device=cuda)
    assert A.is_contiguous() and A.data_ptr() % 16 != 0
    assert Bt.is_contiguous() and Bt.data_ptr() % 16 != 0
    got = dk.residual(A, Bt, arow, col, out_dtype=dtype)
    want = dk.residual_plain(A, Bt, arow, col, out_dtype=dtype)
    torch.cuda.synchronize()
    assert_residual_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_kernel_replays_on_a_side_stream(cuda, dtype):
    """A call captured into a CUDA graph on a side stream (as the body's
    fork runs it) replays the eager call's bits on new operand values;
    the capture counts one launch, the replays none."""
    A, Bt, arow, col = operands(5000, 128, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dk.residual(A, Bt, arow, col, out_dtype=dtype)     # warm-up
        graph = torch.cuda.CUDAGraph()
        before = dk.residual.launches
        with torch.cuda.graph(graph, stream=side):
            captured = dk.residual(A, Bt, arow, col, out_dtype=dtype)
    torch.cuda.current_stream().wait_stream(side)
    assert dk.residual.launches == before + 1
    A.mul_(-0.5)
    Bt.add_(1.0)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert dk.residual.launches == before + 1
    assert torch.equal(captured, dk.residual(A, Bt, arow, col,
                                             out_dtype=dtype))
    assert_residual_close(captured, dk.residual_plain(A, Bt, arow, col,
                                                      out_dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("tier_serialize", ["on", "off"])
@pytest.mark.parametrize("out_dtype", ["float32", "float16"])
def test_body_residual_launches_once_a_call(cuda, out_dtype, tier_serialize):
    """The body on CUDA tensors runs its residual through the kernel, once
    an eager call (on the side stream at "off"), close to the plain body's
    tier; backend="torch" launches it never."""
    plan, cfg, A, Bt = body_case(out_dtype=out_dtype,
                                 tier_serialize=tier_serialize)
    A, Bt = A.to(cuda), Bt.to(cuda)
    dplan = device_plan(plan, cuda, emit="rphm")
    outs = {}
    for backend in ("auto", "torch"):
        body = make_sddmm_body(plan, cfg, backend=backend, emit="rphm")
        before = dk.residual.launches
        outs[backend] = body(A, Bt, dplan)[3]
        assert dk.residual.launches == before + (backend == "auto")
        assert body.forks == int(tier_serialize == "off")
    torch.cuda.synchronize()
    real = slice(0, plan.num_residual)
    assert_residual_close(outs["auto"][real], outs["torch"][real])
