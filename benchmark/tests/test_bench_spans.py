"""The readers of the program's spans and counters (``prep.cluster_s``,
``prep.split_s``, ``prep.upload_s``, ``plan.device_mb``,
``body.useful_pct``) on a run of the tiny cell on the CPU, and against a
store with nothing to read."""

import time

import pytest

from benchmark import harness, loadgen, spec
from benchmark.tests import tiny

from bsmr_sddmm_tpu_torch.utils import profiling

SEED = 2**31 + 4242
NAMES = ("prep.cluster_s", "prep.split_s", "prep.upload_s",
         "plan.device_mb", "body.useful_pct")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A traced run of the tiny cell, its result and its body's plan, on
    a clean store: the spans of runs made before in this process are not
    read."""
    profiling.clear()
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    c = {}
    prepare_cell = loadgen.Cell.prepare

    def prepare(self, run_dir):
        run = prepare_cell(self, run_dir)
        c["plan"] = self.plan
        return run

    loadgen.Cell.prepare = prepare
    try:
        run, bench, cell, config = harness.execute(
            tiny.CELL, SEED, 0.2, True, "cpu", time.perf_counter(),
            root=root)
    finally:
        loadgen.Cell.prepare = prepare_cell
    out = harness.result(run, bench, cell, config, True, 1, root=root)
    return run, out, c["plan"], root


def read(name, run, root=spec.ROOT):
    return spec.metric(name, root).read(run)


def check_declared_for_every_cell(bench):
    """Every cell is listed by exactly one entry of each metric: the
    metric itself, or a split ``<metric>.<part>`` of it, so that a new cell
    is covered by new split entries alone."""
    cells = [w["name"] for w in bench["workloads"]]
    for name in NAMES:
        entries = [m for m in bench["per_layer"] if name in
                   (m["name"], m["name"].rsplit(".", 1)[0])]
        for cell in cells:
            assert sum(cell in m.get("workloads", cells)
                       for m in entries) == 1, (name, cell)


def test_declared_for_every_cell():
    check_declared_for_every_cell(spec.load_benchmark())


@pytest.mark.parametrize("name", NAMES)
def test_values_present_and_positive(traced, name):
    run, out, _, root = traced
    value = out["metrics"][name]["value"]
    assert isinstance(value, float) and value > 0
    assert value == read(name, run, root)


def test_preprocessing_parts_under_prep_s(traced):
    """The spans lie inside the timed preprocessings, so their least
    parts sum to less than the fastest whole."""
    _, out, _, _ = traced
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert got["prep.cluster_s"] + got["prep.split_s"] + \
        got["prep.pack_s"] + got["prep.upload_s"] < got["prep_s"]


def test_useful_share_is_the_plans_own(traced):
    _, out, plan, _ = traced
    slots = (plan.tile_scatter.size + plan.sp_scatter.size
             + plan.g_scatter.size + plan.res_out.size)
    assert out["metrics"]["body.useful_pct"]["value"] == \
        100.0 * plan.nnz / slots


def test_device_mb_is_the_uploaded_plan(traced):
    run, out, plan, _ = traced
    from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan
    want = sum(t.nbytes for t in device_plan(plan, "cpu")) / 2**20
    assert out["metrics"]["plan.device_mb"]["value"] == want


def test_split_reads_the_timed_split_only(traced):
    """Set-up recomputes the column split outside the timed span: that
    split is a root of its own, and a faster root split changes nothing."""
    run, out, _, root = traced
    splits = [s for s in profiling.spans() if s.name == "prep.split"]
    assert any(s.parent is None for s in splits)
    before = read("prep.split_s", run, root)
    with profiling.span("prep.split"):
        pass
    assert read("prep.split_s", run, root) == before
    timed = {s.id for s in profiling.spans() if s.name == "prep.plan"}
    assert before == min(s.duration_ns for s in splits
                         if s.parent in timed) / 1e9


@pytest.mark.parametrize("name", NAMES)
def test_none_from_an_empty_store(traced, name, monkeypatch):
    run = traced[0]
    monkeypatch.setattr(profiling, "_host", type(profiling._host)())
    monkeypatch.setattr(profiling, "_counts", type(profiling._counts)())
    assert read(name, run) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_from_a_program_without_the_store(traced, name, monkeypatch):
    run = traced[0]
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    assert read(name, run) is None
