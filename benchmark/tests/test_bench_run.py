"""A run of the harness on the CPU, on the tiny cell (the plain versions of
the port's kernels): the result line's schema, the check that a sound run
passes, and that the control and a broken timed path fail it."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, loadgen, spec
from benchmark.tests import tiny

from bsmr_sddmm_tpu_torch import BsmrSddmm

SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _result(root, trace=False, settings=None, seed=SEED):
    run, bench, cell, config = harness.execute(
        tiny.CELL, seed, 0.2, trace, "cpu", time.perf_counter(),
        root=root, settings=settings)
    return run, harness.result(run, bench, cell, config, trace, 1, root=root)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(root, trace):
    run, out = _result(root, trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    json.loads(json.dumps(out))
    bench = spec.load_benchmark(root)
    want = {m["name"]: m["unit"]
            for m in spec.metrics_of(bench, tiny.CELL, trace)}
    for name, metric in out["metrics"].items():
        assert metric["unit"] == want[name]
        assert isinstance(metric["value"], float) and metric["value"] > 0
    if trace:
        # no device trace on the CPU: its readers report nothing, and
        # every other per-layer reader reports
        assert set(out["metrics"]) == {
            m["name"] for m in spec.metrics_of(bench, tiny.CELL, True)
            if m["source"] != "device_trace"}
        assert out["metrics"]["prep_s"]["value"] == min(run.prep_s)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert set(out["metrics"]) == set(want) == {
            "sddmm_gflops", "call_ms_p95", "setup_s"}
        assert len(run.prep_s) == len(run.prep_pack_ms) == \
            len(run.prep_reorder_ms) == loadgen.PREP_REPEATS
    assert run.calls == len(run.spans_ms) > 0
    for check in out["checks"].values():
        assert set(check) == {"value", "limit"}


def test_same_seed_same_inputs_and_readings(root):
    a, _ = _result(root)
    b, _ = _result(root)
    c, _ = _result(root, seed=SEED + 1)
    assert a.pair_errs == b.pair_errs != c.pair_errs


def test_control_fails(root):
    """The program's own lower precision, one TF32 pass
    (``matmul_precision="default"``), is the control."""
    run, out = _result(root, settings={"matmul_precision": "default"})
    assert out["correct"] is False
    assert run.max_rel_err > 3 * out["checks"]["max_rel_err"]["limit"]


def _broken(fault):
    """A body factory whose calls go wrong in the way ``fault`` names."""
    compile_body = BsmrSddmm.compile

    def compile(self, plan, backend=None, emit="csr"):
        fn = compile_body(self, plan, backend, emit)
        first = []

        def body(A, Bt, dplan):
            out = fn(A, Bt, dplan)
            if fault == "unchanged":        # the first answer, every call
                if not first:
                    first.append(out)
                return first[0]
            if fault == "half":             # half of the nonzeros left out
                out = out.clone()
                out[out.shape[0] // 2:] = 0
                return out
            out = out.clone()               # one answer altered
            out[out.shape[0] // 3] *= 1 + 1e-3
            return out

        body.forks = 0
        return body
    return compile


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    monkeypatch.setattr(BsmrSddmm, "compile", _broken(fault))
    _, out = _result(root)
    assert out["correct"] is False and out["failed"] > 0


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, os.path.join(spec.ROOT, "benchmark", "run.py"),
         "--workload", spec.load_benchmark()["workloads"][0]["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout == ""
    assert not torch.cuda.is_available() or "no CUDA card" in proc.stderr
