"""The CSR emission of the port's body (``dense_kernels.csr_emit``,
csrc/csr_emit.cu): the plain version against NumPy's join and take, the
wrapper's contract, the ``emit="csr"`` body on the CPU, and — on a CUDA
device only — the kernel against the plain version, bit for bit, eager and
inside a captured CUDA graph.

The emission moves bits and computes nothing, so every comparison here is
exact (``torch.equal``), for fp32 and fp16 values alike.

The tests marked ``cuda`` import nothing of JAX, so that they run on a
machine without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_csr_emit.py`` (tests/conftest.py imports jax)."""

import os

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (this worker's thread budget)

import bsmr_sddmm_tpu_torch as bt
from bsmr_sddmm_tpu_torch.formats import random_mask
from bsmr_sddmm_tpu_torch.ops import _build
from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan, make_sddmm_body
from bsmr_sddmm_tpu_torch.utils import profiling

SMALL = dict(rows=512, cols=768, nnz=20000, seed=7, block_rows=24,
             block_cols=96)
BASE_CFG = dict(k=32, panel_height=16, block_width=128, dense_chunk=64,
                residual_chunk=4096)
#: the tier that each case leaves empty (None: all four filled)
EMPTY = (None, "packed", "gathered", "residual")
DTYPES = (torch.float32, torch.float16)


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none (decided here,
    at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the GPU run python -m pytest "
                    "--noconftest -m cuda tests/test_torch_csr_emit.py")
    return torch.device("cuda")


def tier_case(empty, nnz, dtype, seed=0, ph=8, bw=128):
    """Four tiers of random values, ``empty`` with no slots, and an int32
    map of ``nnz`` distinct slots of their join in random order (as a
    plan's ``rphm_to_csr`` picks the real slots in CSR order)."""
    rng = np.random.default_rng(seed)
    shapes = {"dense": (5, ph, bw), "packed": (3, ph, bw),
              "gathered": (2, ph, bw), "residual": (777,)}
    if empty is not None:
        shapes[empty] = (0,) + shapes[empty][1:]
    tiers = [rng.standard_normal(shape).astype(np.float32)
             for shape in shapes.values()]
    total = sum(t.size for t in tiers)
    idx = rng.choice(total, size=nnz, replace=False).astype(np.int32)
    return [torch.from_numpy(t).to(dtype) for t in tiers], \
        torch.from_numpy(idx)


def numpy_emit(tiers, idx):
    """NumPy's join of the flattened tiers, taken along ``idx``."""
    joined = np.concatenate([t.reshape(-1).numpy() for t in tiers])
    return torch.from_numpy(joined[idx.numpy()])


# ---------------------------------------------------------------------------
# CPU: the plain version, the wrapper's contract, the csr body
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("empty", EMPTY)
def test_csr_emit_plain_takes_from_the_joined_tiers(dtype, empty):
    """The plain version, and the wrapper on CPU tensors (no launch), equal
    NumPy's join and take, with each of packed, gathered and residual
    empty in turn."""
    tiers, idx = tier_case(empty, 1001, dtype)
    want = numpy_emit(tiers, idx)
    before = dk.csr_emit.launches
    for got in (dk.csr_emit_plain(tiers, idx), dk.csr_emit(tiers, idx)):
        assert got.dtype == dtype
        assert torch.equal(got, want)
    assert dk.csr_emit.launches == before


def test_csr_emit_rejects_bad_inputs():
    tiers, idx = tier_case(None, 64, torch.float32)
    with pytest.raises(ValueError, match="four tiers"):
        dk.csr_emit(tiers[:3], idx)
    with pytest.raises(ValueError, match="int32"):
        dk.csr_emit(tiers, idx.long())
    with pytest.raises(ValueError, match="one dtype"):
        dk.csr_emit(tiers[:3] + [tiers[3].half()], idx)
    with pytest.raises(ValueError, match="4 or 2 bytes"):
        dk.csr_emit([t.double() for t in tiers], idx)


def test_csr_emit_refuses_slots_past_int32():
    """Four tiers of 2^31 slots together do not fit rphm_to_csr's int32
    offsets: refused before any device is touched (meta tensors)."""
    meta = torch.device("meta")
    tiers = [torch.empty(2 ** 30, device=meta), torch.empty(0, device=meta),
             torch.empty(2 ** 30 - 1, device=meta),
             torch.empty(1, device=meta)]
    idx = torch.empty(8, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="int32 offsets"):
        dk.csr_emit(tiers, idx)


def body_case(kind="bsr", **cfg_kw):
    """(plan, config, A, Bt) of a small plan with all four tiers: a bsr
    plan, or a reorder plan with the fused gathered tier."""
    csr = random_mask(**SMALL)
    extra = (dict(delta=0.1, col_mode="reorder", gathered_backend="fused")
             if kind == "reorder_fused" else {})
    cfg = bt.SddmmConfig(**dict(BASE_CFG, **extra, **cfg_kw))
    plan = bt.pack_tiles(csr, bt.BsmrSddmm(csr, cfg).reorder(), cfg)
    assert plan.num_tiles and plan.num_packed and plan.num_gathered
    assert plan.num_residual
    A = torch.from_numpy(bt.make_dense(csr.rows, cfg.k, seed=5))
    Bt = torch.from_numpy(bt.make_dense(csr.cols, cfg.k, seed=6))
    return plan, cfg, A, Bt


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("out_dtype", ["float32", "float16"])
def test_csr_body_on_cpu_takes_from_the_rphm_tiers(backend, out_dtype):
    """A CPU body with emit="csr" returns its rphm tiers joined and taken
    along rphm_to_csr, as before the emission kernel, and the csr_scatter
    body's first nnz values; no kernel launches."""
    plan, cfg, A, Bt = body_case(out_dtype=out_dtype)
    dplan = device_plan(plan, "cpu")
    before = dk.csr_emit.launches
    got = make_sddmm_body(plan, cfg, backend=backend)(A, Bt, dplan)
    tiers = make_sddmm_body(plan, cfg, backend=backend, emit="rphm")(
        A, Bt, dplan)
    scattered = make_sddmm_body(plan, cfg, backend=backend,
                                emit="csr_scatter")(A, Bt, dplan)
    assert got.shape == (plan.nnz,)
    assert torch.equal(got, numpy_emit(tiers, dplan.rphm_to_csr))
    assert torch.equal(got, scattered[:plan.nnz])
    assert dk.csr_emit.launches == before


def test_csr_emit_source_is_built_and_traced():
    """csr_emit.cu compiles with the other sources (so it is in the
    library's hash), and the benchmark's trace reader counts its kernel
    as a hand kernel."""
    from benchmark import tracing
    assert "csr_emit.cu" in _build.SOURCES
    names = tracing.hand_kernel_names(os.path.dirname(bt.__file__))
    assert "csr_emit_kernel" in names
    assert tracing.is_hand(
        "void (anonymous namespace)::csr_emit_kernel<unsigned int>("
        "(anonymous namespace)::Tiers<unsigned int>, int const*, "
        "unsigned int*, int, bool)", names)


def test_counters_report_csr_emit_launches(monkeypatch):
    monkeypatch.setattr(dk.csr_emit, "launches", 11)
    assert profiling.counters()["csr_emit.launches"] == 11


def test_every_counting_wrapper_is_registered_once(monkeypatch):
    """dense_kernels.WRAPPERS holds every wrapper with a launch counter;
    profiling.counters() and chip_smoke.py's kernel set read it."""
    import chip_smoke
    counting = {name for name, fn in vars(dk).items()
                if callable(fn) and hasattr(fn, "launches")}
    names = [fn.__name__ for fn in dk.WRAPPERS]
    assert sorted(names) == sorted(counting) == sorted(chip_smoke.KERNELS)
    for i, fn in enumerate(dk.WRAPPERS):
        monkeypatch.setattr(fn, "launches", 100 + i)
    got = profiling.counters()
    assert {n: got[f"{n}.launches"] for n in names} == {
        n: 100 + i for i, n in enumerate(names)}


@pytest.mark.parametrize("dtype,idx,want_sectors", [
    (torch.float32, list(range(64)), 8),          # all of dense, 8 sectors
    (torch.float32, list(range(0, 64, 8)), 8),    # one value a sector
    (torch.float32, [64, 65, 80, 84], 2),         # gathered, then residual
    (torch.float16, list(range(64)), 4),          # 2-byte values, 4 sectors
])
def test_emit_work_counts_index_value_and_sector_bytes(dtype, idx,
                                                       want_sectors):
    """emit_work: 4 bytes of index and one value written a nonzero, and
    each distinct 32-byte sector of the values read once; packed empty."""
    tiers = [torch.zeros(64, dtype=dtype), torch.zeros(0, dtype=dtype),
             torch.zeros(16, dtype=dtype), torch.zeros(5, dtype=dtype)]
    assert all(t.data_ptr() % 32 == 0 for t in tiers if t.numel())
    idx = torch.tensor(idx, dtype=torch.int32)
    work = dk.emit_work(tiers, idx)
    elem = tiers[0].element_size()
    assert work["sectors"] == want_sectors
    assert work["bytes"] == idx.numel() * (4 + elem) + 32 * want_sectors
    assert work["bound_ms"] == pytest.approx(
        work["bytes"] / dk.H100_BYTES_PER_S * 1e3, rel=1e-12)
    assert work["bound_by"] == "bytes"


# ---------------------------------------------------------------------------
# CUDA: the kernel against the plain version, eager and captured
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("empty", EMPTY)
@pytest.mark.parametrize("nnz,offset", [(4096, 0), (1001, 0), (1001, 1)])
def test_csr_emit_kernel_equals_plain(cuda, dtype, empty, nnz, offset):
    """Bit for bit against the plain version on the card, one launch a
    call: all four tiers filled and each of packed, gathered and residual
    empty; nnz a multiple of the vector width or not; a map that starts
    off the 16-byte alignment (every thread copies one value at a time)."""
    tiers, idx = tier_case(empty, nnz + offset, dtype, seed=nnz + offset)
    tiers = [t.to(cuda) for t in tiers]
    idx = idx.to(cuda)[offset:]
    assert (idx.data_ptr() % 16 == 0) == (offset == 0)
    before = dk.csr_emit.launches
    got = dk.csr_emit(tiers, idx)
    assert dk.csr_emit.launches == before + 1
    want = dk.csr_emit_plain(tiers, idx)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (nnz,)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_csr_emit_kernel_with_no_nonzeros_launches_nothing(cuda):
    tiers, _ = tier_case(None, 0, torch.float32)
    idx = torch.empty(0, dtype=torch.int32, device=cuda)
    before = dk.csr_emit.launches
    out = dk.csr_emit([t.to(cuda) for t in tiers], idx)
    assert out.shape == (0,) and dk.csr_emit.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "float16"])
@pytest.mark.parametrize("kind", ["bsr", "reorder_fused"])
def test_csr_body_graph_replay_equals_cat_path(cuda, kind, out_dtype):
    """The emit="csr" body at tier_serialize="off" (the gathered tier and
    the residual forked onto the side stream) returns, eager and as a
    replayed CUDA graph, the same bits as the cat + index_select of its
    rphm tiers on the card; csr_emit launches once an eager call and once
    at capture, never in a replay."""
    plan, cfg, A, Bt = body_case(kind, out_dtype=out_dtype,
                                 tier_serialize="off")
    A, Bt = A.to(cuda), Bt.to(cuda)
    dplan = device_plan(plan, cuda)
    body = make_sddmm_body(plan, cfg)
    want = dk.csr_emit_plain(
        make_sddmm_body(plan, cfg, emit="rphm")(A, Bt, dplan),
        dplan.rphm_to_csr)
    before = dk.csr_emit.launches
    eager = body(A, Bt, dplan)
    assert dk.csr_emit.launches == before + 1
    side = torch.cuda.Stream()                # warm-up off the main stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(A, Bt, dplan)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = body(A, Bt, dplan)
    assert dk.csr_emit.launches == before + 3
    assert body.forks == 3
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    assert dk.csr_emit.launches == before + 3
    assert torch.equal(eager, want)
    assert torch.equal(captured, want)
