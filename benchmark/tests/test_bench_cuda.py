"""On the card (marker ``cuda``; skipped without one): the tiny cell's
replayed calls pass the check, and the control and a broken timed path
fail it. Run on the card with

    python -m pytest --noconftest -m cuda benchmark/tests
"""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny
from benchmark.tests.test_bench_run import _broken

from bsmr_sddmm_tpu_torch import BsmrSddmm

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def root(card, tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"), mode="replay")


def _result(root, card, trace=False, settings=None, seed=7):
    run, bench, cell, config = harness.execute(
        tiny.cell("replay"), seed, 0.5, trace, card, time.perf_counter(),
        root=root, settings=settings)
    return run, harness.result(run, bench, cell, config, trace, 1,
                               root=root)


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 5])
def test_replay_is_correct(root, card, seed):
    run, out = _result(root, card, seed=seed)
    assert out["correct"] is True and run.calls > 100
    assert out["device"]["platform"] == "gpu"
    assert out["metrics"]["sddmm_gflops"]["value"] > 0


def test_traced_replay_reads_the_device(root, card):
    _, out = _result(root, card, trace=True)
    assert out["correct"] is True
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["metrics"]["kernels.hand_ms"]["value"] > 0
    assert 0 < out["metrics"]["call.roofline_pct"]["value"] <= 100


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails(root, card, seed):
    run, out = _result(root, card, seed=seed,
                       settings={"matmul_precision": "default"})
    assert out["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(root, card, monkeypatch, fault):
    monkeypatch.setattr(BsmrSddmm, "compile", _broken(fault))
    _, out = _result(root, card)
    assert out["correct"] is False and out["failed"] > 0


def test_replay_outputs_survive_a_partial_round(root, card):
    """A window may end inside a round of the ring: every pair's output
    must still be its own."""
    import os
    from benchmark import loadgen, spec
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, tiny.cell("replay"))
    config = spec.config(bench, "tiny", root)
    c = loadgen.Cell(config, spec.traffic(cell["traffic"], root), card)
    run = c.prepare(os.path.join(root, "build"))
    c.load(run, 3)          # warm-up: pairs 0 and 1
    assert run.pairs == 3
    c.caller(2)
    c.caller(0)             # pair 1 was replayed before pairs 2 and 0
    c.check(run)
    assert max(run.pair_errs) <= config["check"]["max_rel_err"]
