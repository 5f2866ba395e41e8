"""The port's spans and counters (``utils.profiling``): the preprocessing's
span tree and its timers, the body's tier spans while recording and none
while not, the counters, and the exporters.

The tests marked ``cuda`` import nothing of JAX, so that they run on a
machine without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_profiling.py`` (tests/conftest.py imports jax)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (this worker's thread budget)

import bsmr_sddmm_tpu_torch as bt
from bsmr_sddmm_tpu_torch.formats import random_mask
from bsmr_sddmm_tpu_torch.ops import _build
from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan, make_sddmm_body
from bsmr_sddmm_tpu_torch.reorder import row_reordering, split_columns
from bsmr_sddmm_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(rows=512, cols=768, nnz=20000, seed=7, block_rows=24,
             block_cols=96)
BASE_CFG = dict(k=32, panel_height=16, block_width=128, dense_chunk=64,
                residual_chunk=4096, alpha=0.3, delta=0.002,
                subpack_min_nnz=12)
ARMS = {"bsr": {}, "reorder_fused": dict(delta=0.1, col_mode="reorder",
                                         gathered_backend="fused")}
TIERS = ("row_gather", "dense", "packed", "gathered", "residual", "emit")
PHASES = {"prep.cluster": ("encode", "dispersion", "sort", "greedy"),
          "prep.pack": ("join", "layout", "scatter", "packed", "gathered",
                        "windows", "rows")}


@pytest.fixture
def store():
    """An empty store, recording off, for the test."""
    profiling.clear()
    with profiling.record(False):
        yield profiling
    profiling.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the GPU run python -m pytest "
                    "--noconftest -m cuda tests/test_torch_profiling.py")
    return torch.device("cuda")


def case(arm="bsr"):
    csr = random_mask(**SMALL)
    cfg = bt.SddmmConfig(**dict(BASE_CFG, **ARMS[arm]))
    A = torch.from_numpy(bt.make_dense(csr.rows, cfg.k, seed=5))
    Bt = torch.from_numpy(bt.make_dense(csr.cols, cfg.k, seed=6))
    return csr, cfg, A, Bt


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def same_plans(a, b):
    for f in dataclasses.fields(a):
        if f.name == "pack_time_ms":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y or (x != x and y != y), f.name


# -- preprocessing -----------------------------------------------------------

@pytest.mark.parametrize("arm", sorted(ARMS))
def test_plan_records_one_span_tree(store, arm):
    """One ``prep.plan`` root per ``plan()``; the clustering, the column
    split and the packing under it, each with its phases, every child
    inside its parent; the packing's phases cover nearly all of it."""
    csr, cfg, _, _ = case(arm)
    for _ in range(2):
        bt.BsmrSddmm(csr, cfg, device="cpu").plan()
    spans = store.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["prep.plan", "prep.plan"]
    ids = {s.id: s for s in spans}
    for s in spans:
        assert s.end_ns is not None and s.duration_ns >= 0
        assert s.root in {r.id for r in roots}
        if s.parent is not None:
            assert inside(s, ids[s.parent]), s.name
    names = by_name(spans)
    for parent in ("prep.cluster", "prep.split", "prep.pack"):
        assert [ids[s.parent].name for s in names[parent]] == \
            ["prep.plan"] * 2
    for parent, phases in PHASES.items():
        for s in names[parent]:
            kids = [c for c in spans if c.parent == s.id]
            assert [c.name for c in kids] == [f"{parent}.{p}"
                                              for p in phases]
            for a, b in zip(kids, kids[1:]):
                assert a.end_ns <= b.start_ns
    for s in names["prep.pack"]:
        covered = sum(c.duration_ns for c in spans if c.parent == s.id)
        assert covered >= 0.9 * s.duration_ns


def test_timers_are_the_spans(store):
    """``row_time_ms``, ``col_time_ms`` and ``pack_time_ms`` are the
    durations of ``prep.cluster``, ``prep.split`` and ``prep.pack``."""
    csr, cfg, _, _ = case()
    reord = split_columns(csr, row_reordering(csr, cfg.alpha, cfg), cfg)
    plan = bt.pack_tiles(csr, reord, cfg)
    names = by_name(store.spans())
    assert [s.parent for s in names["prep.cluster"] + names["prep.split"]
            + names["prep.pack"]] == [None] * 3
    assert reord.row_time_ms == names["prep.cluster"][0].duration_ms > 0
    assert reord.col_time_ms == names["prep.split"][0].duration_ms > 0
    assert plan.pack_time_ms == names["prep.pack"][0].duration_ms > 0


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_plans_identical_with_recording_on_and_off(store, arm):
    csr, cfg, _, _ = case(arm)
    off = bt.BsmrSddmm(csr, cfg, device="cpu").plan()
    with profiling.record(True):
        on = bt.BsmrSddmm(csr, cfg, device="cpu").plan()
    same_plans(off, on)


def test_upload_span_and_plan_bytes(store):
    csr, cfg, _, _ = case()
    plan = bt.BsmrSddmm(csr, cfg, device="cpu").plan()
    dplan = device_plan(plan, "cpu")
    light = device_plan(plan, "cpu", emit="rphm")
    uploads = [s for s in store.spans() if s.name == "prep.upload"]
    assert len(uploads) == 2 and all(s.parent is None for s in uploads)
    log = [(n, v) for n, v, _, _ in store._counts
           if n == "plan.device_bytes"]
    assert log == [("plan.device_bytes", sum(t.nbytes for t in dplan)),
                   ("plan.device_bytes", sum(t.nbytes for t in light))]
    assert log[1][1] < log[0][1]
    assert store.counters()["plan.device_bytes"] == log[1][1]


# -- the body ----------------------------------------------------------------

@pytest.mark.parametrize("emit", ["csr", "rphm", "csr_scatter"])
def test_cpu_body_spans_only_while_recording(store, emit):
    """Recording on, a call is a ``call`` root with the six tier spans in
    order, and its values are those of a call with recording off, bit for
    bit; recording off, a call records no span and makes no event."""
    csr, cfg, A, Bt = case()
    plan = bt.BsmrSddmm(csr, cfg, device="cpu").plan()
    dplan = device_plan(plan, "cpu")
    body = make_sddmm_body(plan, cfg, emit=emit)
    store.clear()
    made = profiling.events_made
    off = body(A, Bt, dplan)
    assert store.spans() == [] and profiling.events_made == made
    with profiling.record(True):
        on = body(A, Bt, dplan)
    assert profiling.events_made == made
    spans = store.spans()
    root = spans[-1]
    assert root.name == "call" and root.parent is None
    kids = spans[:-1]
    assert [s.name for s in kids] == [f"body.{t}" for t in TIERS]
    assert all(s.parent == root.id and inside(s, root) for s in kids)
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    for got, want in zip(on if emit == "rphm" else [on],
                         off if emit == "rphm" else [off]):
        assert torch.equal(got, want)
    assert store.device_spans() == []


def test_body_counters_are_the_plans_shapes(store):
    csr, cfg, _, _ = case("reorder_fused")
    plan = bt.BsmrSddmm(csr, cfg, device="cpu").plan()
    body = make_sddmm_body(plan, cfg)
    ph, bw = plan.panel_height, plan.block_width
    got = store.counters()
    assert got["body.nnz"] == plan.nnz == csr.nnz
    assert got["body.slots.dense"] == plan.tile_scatter.size
    assert got["body.slots.packed"] == plan.sp_scatter.size
    assert got["body.slots.gathered"] == plan.g_scatter.size
    assert got["body.slots.residual"] == plan.res_out.size
    assert got["body.slots.dense"] == plan.tile_panel.shape[0] * ph * bw
    assert got["body.forks"] == body.forks == 0


def test_counters_read_the_live_counters(store, monkeypatch):
    from bsmr_sddmm_tpu_torch.parallel import collectives
    monkeypatch.setattr(dk.subpack, "launches", 7)
    monkeypatch.setitem(collectives.COUNTS, "all_gather", 3)
    csr, cfg, _, _ = case()
    body = make_sddmm_body(bt.BsmrSddmm(csr, cfg, device="cpu").plan(), cfg)
    body.forks = 5
    got = store.counters()
    assert got["subpack.launches"] == 7
    assert got["collectives.all_gather"] == 3
    assert got["body.forks"] >= 5
    json.dumps(got)


def test_kernel_library_load_is_a_span(store, monkeypatch):
    lib = object()
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_load", lambda: lib)
    assert _build.load_library() is lib
    assert _build.load_library() is lib
    assert [s.name for s in store.spans()] == ["kernels.load"]


# -- exporters ---------------------------------------------------------------

def test_phase_timer_is_a_span(store):
    sink = {}
    with profiling.phase_timer(sink, "generate"):
        pass
    with pytest.raises(KeyError):
        with profiling.phase_timer(sink, "generate"):
            raise KeyError("the time still counts")
    spans = store.spans()
    assert [s.name for s in spans] == ["generate", "generate"]
    assert sink["generate"] == pytest.approx(
        sum(s.duration_ms for s in spans))


def test_span_opens_a_profiler_range(store):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("sddmm_body"):
            torch.ones(4).sum()
    assert "bsmr::sddmm_body" in {e.name for e in prof.events()}


@pytest.mark.parametrize("on", [False, True])
def test_body_span_is_stored_only_while_recording(store, on):
    """The training ranges (``graph_rphm``) open their profiler range
    always and put a span in the store only while recording."""
    from torch.profiler import ProfilerActivity, profile
    with profiling.record(on):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.body_span("spmm_backward"):
                torch.ones(4).sum()
    assert "bsmr::spmm_backward" in {e.name for e in prof.events()}
    assert [s.name for s in store.spans()] == (["spmm_backward"] if on
                                                else [])


def test_trace_writes_the_blocks_spans(store, tmp_path):
    csr, cfg, A, Bt = case()
    pipe = bt.BsmrSddmm(csr, cfg, device="cpu")
    plan = pipe.plan()
    dplan = device_plan(plan, "cpu")
    body = pipe.compile(plan)
    with profiling.trace(str(tmp_path / "tr")) as path:
        body(A, Bt, dplan)
    assert profiling.RECORDING is False
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    with open(tmp_path / "tr" / "spans.json") as f:
        got = json.load(f)
    assert [s["name"] for s in got["host"]] == \
        [f"body.{t}" for t in TIERS] + ["call"]
    assert got["device"] == [] and got["clock"] == "time.perf_counter_ns"
    assert got["counters"]["body.nnz"] == csr.nnz


def test_trace_environment_writes_spans_json(tmp_path):
    """``BSMR_TORCH_TRACE=<dir>`` turns recording on at import and writes
    ``<dir>/spans.json`` at exit, in a process of its own."""
    code = (
        "import torch\n"
        "import bsmr_sddmm_tpu_torch as bt\n"
        "from bsmr_sddmm_tpu_torch.formats import random_mask\n"
        "from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan\n"
        "from bsmr_sddmm_tpu_torch.utils import profiling\n"
        "assert profiling.RECORDING\n"
        f"csr = random_mask(**{SMALL!r})\n"
        f"cfg = bt.SddmmConfig(**{BASE_CFG!r})\n"
        "pipe = bt.BsmrSddmm(csr, cfg, device='cpu')\n"
        "plan = pipe.plan()\n"
        "A = torch.ones(csr.rows, 32); Bt = torch.ones(csr.cols, 32)\n"
        "pipe.compile(plan)(A, Bt, device_plan(plan, 'cpu'))\n")
    env = dict(os.environ, BSMR_TORCH_TRACE=str(tmp_path / "out"),
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with open(tmp_path / "out" / "spans.json") as f:
        got = json.load(f)
    names = [s["name"] for s in got["host"]]
    for name in ("prep.plan", "prep.cluster", "prep.split", "prep.pack",
                 "prep.upload", "call", *(f"body.{t}" for t in TIERS)):
        assert name in names
    assert got["counters"]["body.nnz"] > 0
    assert got["counters"]["plan.device_bytes"] > 0
    assert all(s["end_ns"] >= s["start_ns"] for s in got["host"])


# -- on the card -------------------------------------------------------------

def _capture(body, pairs, dplan):
    """The harness's captures: one call on a side stream, then one CUDA
    graph per operand pair."""
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        body(*pairs[0], dplan)
    cur.wait_stream(side)
    graphs, outs = [], []
    for A, Bt in pairs:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(body(A, Bt, dplan))
        graphs.append(graph)
    return graphs, outs


def _pairs(A, Bt, cuda):
    return [(A.to(cuda), Bt.to(cuda)),
            ((A * 0.5).to(cuda), (Bt + 1.0).to(cuda))]


@pytest.mark.cuda
@pytest.mark.parametrize("serialize", ["on", "off"])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_replayed_graphs_record_a_device_span_per_tier(store, cuda, arm,
                                                       serialize):
    """Recording on, every replayed graph gives a device span per tier,
    each >= 0, the main stream's in order and inside the call; the side
    stream takes the gathered tier and the residual where the call forks;
    the values are those of graphs captured with recording off."""
    csr, cfg, A, Bt = case(arm)
    cfg = cfg.replace(tier_serialize=serialize)
    plan = bt.BsmrSddmm(csr, cfg).plan()
    dplan = device_plan(plan, cuda)
    pairs = _pairs(A, Bt, cuda)
    body = make_sddmm_body(plan, cfg)
    graphs_off, outs_off = _capture(body, pairs, dplan)
    with profiling.record(True):
        graphs_on, outs_on = _capture(body, pairs, dplan)
    for _ in range(3):
        for g in graphs_off + graphs_on:
            g.replay()
    torch.cuda.synchronize()
    for got, want in zip(outs_on, outs_off):
        assert torch.equal(got, want)
    spans = [d for d in store.device_spans() if d["graph"]]
    calls = sorted({d["call"] for d in spans})
    assert len(calls) == len(pairs)
    for call in calls:
        mine = {d["name"]: d for d in spans if d["call"] == call}
        assert set(mine) == {"call"} | {f"body.{t}" for t in TIERS}
        whole = mine.pop("call")
        for d in mine.values():
            assert d["end_ns"] >= d["start_ns"]
            assert whole["start_ns"] <= d["start_ns"]
            assert d["end_ns"] <= whole["end_ns"]
        side = {n for n, d in mine.items() if d["stream"] == "side"}
        assert side == ({"body.gathered", "body.residual"}
                        if serialize == "off" else set())
        main = [mine[f"body.{t}"] for t in TIERS
                if f"body.{t}" not in side]
        for a, b in zip(main, main[1:]):
            assert a["end_ns"] <= b["start_ns"]
        for n in side:
            assert mine[n]["start_ns"] >= mine["body.row_gather"]["end_ns"]
            assert mine[n]["end_ns"] <= mine["body.emit"]["start_ns"]
    # read again: the same calls, each graph's last replay
    again = [d for d in store.device_spans() if d["graph"]]
    assert len(again) == len(spans)


@pytest.mark.cuda
def test_capture_with_recording_off_makes_no_event(store, cuda):
    csr, cfg, A, Bt = case()
    plan = bt.BsmrSddmm(csr, cfg).plan()
    dplan = device_plan(plan, cuda)
    body = make_sddmm_body(plan, cfg.replace(tier_serialize="off"))
    store.clear()
    made = profiling.events_made
    graphs, _ = _capture(body, _pairs(A, Bt, cuda), dplan)
    for g in graphs:
        g.replay()
    torch.cuda.synchronize()
    assert profiling.events_made == made
    assert store.spans() == [] and store.device_spans() == []
    assert not store._captured and not store._pending


@pytest.mark.cuda
def test_eager_calls_take_events_from_the_pool(store, cuda):
    """Eager calls with recording on: device spans on the host clock,
    inside their host span; after a read, the next call makes no event."""
    csr, cfg, A, Bt = case()
    plan = bt.BsmrSddmm(csr, cfg).plan()
    dplan = device_plan(plan, cuda)
    body = make_sddmm_body(plan, cfg.replace(tier_serialize="off"))
    A, Bt = A.to(cuda), Bt.to(cuda)
    want = body(A, Bt, dplan)
    with profiling.record(True):
        got = body(A, Bt, dplan)
        spans = store.device_spans()
        made = profiling.events_made
        body(A, Bt, dplan)
        assert profiling.events_made == made
    assert torch.equal(got, want)
    host = {s.id: s for s in store.spans()}
    assert {d["name"] for d in spans} == \
        {"call"} | {f"body.{t}" for t in TIERS}
    for d in spans:
        assert d["graph"] is False and d["end_ns"] >= d["start_ns"]
        # a tier's device work starts after its host span does
        assert d["start_ns"] >= host[d["span"]].start_ns - 50_000
    assert len(store.device_spans()) == 2 * len(spans)


@pytest.mark.cuda
def test_a_graph_never_replayed_gives_no_span(store, cuda):
    csr, cfg, A, Bt = case()
    plan = bt.BsmrSddmm(csr, cfg).plan()
    dplan = device_plan(plan, cuda)
    body = make_sddmm_body(plan, cfg.replace(tier_serialize="off"))
    with profiling.record(True):
        _capture(body, _pairs(A, Bt, cuda), dplan)
    torch.cuda.synchronize()
    assert len(store._captured) == 2
    assert [d for d in store.device_spans() if d["graph"]] == []
    assert torch.cuda.is_available()        # the card is still sound
    assert float(torch.ones(2, device=cuda).sum()) == 2.0


def _union_by_name_ms(prof) -> float:
    """Milliseconds in which a device event of ``prof`` runs, user
    annotations and the ranges named ``bsmr::*`` and ``Optimizer.*`` left
    out by their names."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith(("bsmr::", "Optimizer.")))
    total, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


@pytest.mark.cuda
def test_chip_smoke_split_keeps_tier_spans_in_the_body(store, cuda):
    """``chip_smoke.step_split`` counts a kernel for the outermost
    ``bsmr::`` range, so the tier spans inside ``bsmr::sddmm_body`` leave
    its kernels there; ``union_ms`` (the benchmark's busy union) is the
    union of the device events that a filter by name keeps."""
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, REPO)
    import chip_smoke
    csr, cfg, A, Bt = case()
    plan = bt.BsmrSddmm(csr, cfg).plan()
    dplan = device_plan(plan, cuda)
    body = make_sddmm_body(plan, cfg, emit="rphm")
    A, Bt = A.to(cuda), Bt.to(cuda)

    def step():
        with profiling.span("sddmm_body"):
            out = body(A, Bt, dplan)
        return float(out[3].sum())

    body(A, Bt, dplan)
    labels = {}
    for on in (False, True):
        with profiling.record(on):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
        labels[on] = chip_smoke.ms_by_label(prof)
        # the union leaves out the profiler's device-side ranges, the
        # nested bsmr::body.* ones too, as a filter by name does
        assert chip_smoke.union_ms(prof) == pytest.approx(
            _union_by_name_ms(prof), rel=1e-9)
        assert _union_by_name_ms(prof) > 0
    assert set(labels[True]) == set(labels[False]) == {
        "bsmr::sddmm_body", "rest"}
    assert labels[True]["bsmr::sddmm_body"] > 0
    with profiling.record(True):
        split, loss = chip_smoke.step_split(torch, step)
    assert split["body"] > 0 and split["hand"] > 0
    assert loss == step()
