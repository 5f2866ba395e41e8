"""The port's arm-selection and harness tools (``bsmr_sddmm_tpu_torch/tools``)
against the JAX package's ``scripts/`` on the CPU, on the same inputs.

Each test imports the JAX script from ``scripts/`` (as
tests/test_check_autotune.py does) and the port's module. The logs come
from the port's own sweeps on the CPU: ``bench.suite.run(full_grid=True)``
on banded_mesh_12k at K=128, and ``bench.replica_suite`` on the smallest
manifest replica at K=32 and K=128 with subpack 0 only. Equal means equal:
parses, rows, summaries and cache files; the refit table and quality, and
the scaling model's JSON, to 1e-12.
"""

import ast
import importlib
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import bsmr_sddmm_tpu.autotune as jat
import bsmr_sddmm_tpu.datasets as jds
import bsmr_sddmm_tpu.utils.compilecache as jcompilecache

import bsmr_sddmm_tpu_torch.autotune as tat
import bsmr_sddmm_tpu_torch.datasets as tds
from bsmr_sddmm_tpu_torch.bench import replica_suite, suite
from bsmr_sddmm_tpu_torch.tools import (audit_cost_model, check_autotune,
                                        fit_costs_from_audit,
                                        predict_scaling, probe_refine_pick,
                                        probe_tier_calibration,
                                        profile_tiers, run_weak_scaling)
from bsmr_sddmm_tpu_torch.tools import prewarm_reorder_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("check_autotune", "audit_cost_model", "probe_tier_calibration",
         "fit_costs_from_audit", "probe_refine_pick", "profile_tiers",
         "prewarm_reorder_cache", "predict_scaling", "run_weak_scaling")
#: the smallest manifest replica (vsp_barth5_1Ksep_50in_5Kout, 101 805 nnz)
REPLICA = ["--count", "1", "--max-nnz", "102000"]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(a, b, tol=1e-12):
    """Recursive equality, floats to ``tol`` (relative and absolute)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=tol, abs_tol=tol), (a, b)
    else:
        assert a == b


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch, tmp_path):
    monkeypatch.setattr(jcompilecache, "enable_compile_cache",
                        lambda *a, **k: None)
    # the port's enable_compile_cache() sets it; put back after the test
    monkeypatch.setenv("BSMR_TORCH_KERNEL_DIR", str(tmp_path / "kernels"))


# ---------------------------------------------------------------------------
# check_autotune
# ---------------------------------------------------------------------------

# the log of tests/test_check_autotune.py: positional subpack arms, a new
# alpha restarting the counter, an fp16 line that must not match
JAX_TEST_LOG = "".join(
    f"# m1 a={a} d={d} k=128{tag}: {gf} GFLOPS (1 ms, dense 1, gath 0, "
    f"res 0, fill 0.1)\n"
    for a, d, tag, gf in (("0.1", "0.002", "", 100), ("0.1", "0.006", "", 110),
                          ("0.1", "0.002", "", 120), ("0.1", "0.02", "", 90),
                          ("0.3", "0.002", "", 95),
                          ("0.3", "0.002", " dt=f16", 130)))


def test_parse_log_equal_on_jax_test_log(tmp_path):
    path = tmp_path / "bench.log"
    path.write_text(JAX_TEST_LOG)
    got = check_autotune.parse_log(str(path))
    assert got == _script("check_autotune").parse_log(str(path))
    assert got[("m1", 128)] == {(0.1, 0.002, 0): 100.0,
                                (0.1, 0.006, 0): 110.0,
                                (0.1, 0.002, 12): 120.0,
                                (0.1, 0.02, 12): 90.0,
                                (0.3, 0.002, 0): 95.0}
    assert check_autotune.PAT.pattern == _script("check_autotune").PAT.pattern
    assert check_autotune.BENCH_CONFIGS == suite.CONFIGS


@pytest.fixture(scope="module")
def sweep_log(tmp_path_factory):
    """The lines bench.suite.run(full_grid=True) echoes for
    banded_mesh_12k at K=128 on the CPU, in a log file, the arm records
    of the same run beside it (``arms.json``, as ``--arms`` writes them),
    and the reorder cache they left."""
    root = tmp_path_factory.mktemp("sweep")
    lines, records = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BSMR_CACHE_DIR", str(root / "cache"))
        gen = dict(tds.SUITE)["banded_mesh_12k"]
        out = suite.run([("banded_mesh_12k", gen)], ks=(128,),
                        device="cpu", full_grid=True, echo=lines.append,
                        records=records)
    assert "failed_cells" not in out
    path = root / "sweep.log"
    path.write_text("\n".join(lines) + "\n")
    (root / "arms.json").write_text(json.dumps(records))
    return path


def test_parse_log_equal_on_suite_sweep(sweep_log):
    got = check_autotune.parse_log(str(sweep_log))
    assert got == _script("check_autotune").parse_log(str(sweep_log))
    grid = got[("banded_mesh_12k", 128)]
    assert sorted(grid) == sorted(
        (a, d, s) for a in suite.ALPHAS for d, s in suite.CONFIGS)


@pytest.mark.parametrize("auto_alpha", (False, True))
def test_check_rows_equal_jax_main(sweep_log, tmp_path, monkeypatch,
                                   auto_alpha):
    """check() on the sweep's parse gives JAX main's rows: the same
    picked arm, best arm and fraction per (matrix, K)."""
    monkeypatch.setenv("BSMR_CACHE_DIR", str(sweep_log.parent / "cache"))
    flag = ["--auto-alpha"] if auto_alpha else []
    out = tmp_path / "jax.json"
    assert _script("check_autotune").main(
        [str(sweep_log), "--ks", "128", "--out", str(out)] + flag) == 0
    want = json.loads(out.read_text())
    got = check_autotune.check(check_autotune.parse_log(str(sweep_log)),
                               tds.SUITE, ks=(128,), auto_alpha=auto_alpha,
                               costs=tat.V5E_COSTS, echo=lambda _: None)
    assert json.loads(json.dumps(got)) == want
    assert len(want["rows"]) == 1 and want["rows"][0]["fraction"]
    assert tat._CALIBRATED is None   # the pricing table is put back
    mine = tmp_path / "torch.json"
    assert check_autotune.main([str(sweep_log), "--ks", "128", "--out",
                                str(mine), "--device", "cpu"] + flag) == 0
    assert json.loads(mine.read_text()) == want


def _rounded(runs):
    """Records' GFLOPS as the echoed line prints them."""
    return {key: {arm: float(f"{g:.0f}") for arm, g in grid.items()}
            for key, grid in runs.items()}


def test_records_agree_with_the_parse_of_a_clean_sweep(sweep_log, tmp_path,
                                                       monkeypatch):
    """Where no arm is skipped the positional parse is right: the records
    name the same 12 fp32 arms with the same GFLOPS, and one fp16 arm;
    main --arms picks what main on the log picks, and its best is the
    records' (the log's GFLOPS are rounded to integers, so on the CPU's
    few GFLOPS its best may be a tie's first arm)."""
    monkeypatch.setenv("BSMR_CACHE_DIR", str(sweep_log.parent / "cache"))
    arms = sweep_log.parent / "arms.json"
    records = json.loads(arms.read_text())
    assert [r["dtype"] for r in records].count("float16") == 1
    runs = check_autotune.runs_from_records(records)
    assert _rounded(runs) == dict(check_autotune.parse_log(str(sweep_log)))
    assert records[0]["check"] == "pass"
    rows = []
    for src in (["--arms", str(arms)], [str(sweep_log)]):
        out = tmp_path / "rows.json"
        assert check_autotune.main(src + ["--ks", "128", "--out", str(out),
                                          "--device", "cpu"]) == 0
        rows.append(json.loads(out.read_text())["rows"])
    assert len(rows[0]) == len(rows[1]) == 1
    assert rows[0][0]["picked"] == rows[1][0]["picked"]
    grid = runs[("banded_mesh_12k", 128)]
    assert rows[0][0]["best_gflops"] == max(grid.values())
    assert tuple(rows[0][0]["best"]) == max(grid, key=grid.get)[1:]


def test_records_attribute_a_skipped_group_right(monkeypatch, tmp_path):
    """Fault 1: an arm that prints ``skipped (plan maps ...)`` shifts the
    positional parse of the rest of its (matrix, alpha, K) group, which then
    files the subpack-12 arm at delta 0.002 under subpack 0 (as the JAX
    script does); the records attribute every arm that ran right."""
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path))
    calls = []
    plan_bytes = suite.plan_bytes

    def first_arm_too_big(plan):
        calls.append(plan)
        return suite.MAX_PLAN_BYTES + 1 if len(calls) == 1 else \
            plan_bytes(plan)
    monkeypatch.setattr(suite, "plan_bytes", first_arm_too_big)
    lines, records = [], []
    out = suite.run([("tiny", lambda: tds.community(1024, 12000, 8,
                                                     seed=47))],
                    ks=(128,), device="cpu", full_grid=True,
                    echo=lines.append, records=records)
    assert "failed_cells" not in out
    assert sum("skipped (plan maps" in ln for ln in lines) == 1
    runs = check_autotune.runs_from_records(records)[("tiny", 128)]
    first = (suite.ALPHAS[0],) + suite.CONFIGS[0]
    assert sorted(runs) == sorted(
        (a, d, s) for a in suite.ALPHAS for d, s in suite.CONFIGS
        if (a, d, s) != first)
    log = tmp_path / "sweep.log"
    log.write_text("\n".join(lines) + "\n")
    parsed = check_autotune.parse_log(str(log))[("tiny", 128)]
    assert parsed == _script("check_autotune").parse_log(str(log))[
        ("tiny", 128)]
    # the parse reads the subpack-12 arm at delta 0.002 as subpack 0
    misread = (suite.ALPHAS[0], 0.002, 12)
    assert parsed[first] == float(f"{runs[misread]:.0f}")
    assert misread not in parsed
    assert _rounded({0: runs})[0] != parsed


@pytest.mark.parametrize("auto_alpha", (False, True))
def test_check_times_a_pick_outside_the_grid(sweep_log, monkeypatch,
                                             tmp_path, auto_alpha):
    """Fault 2: on a sweep that lacks the picked arm, check() leaves the
    row's fraction None, as the JAX script does; with time_outside_grid (in
    main: --time-outside-grid) it times the pick on the device and the row
    gets a fraction. With alpha chosen the picked arm is taken out; at the
    fixed alpha 0.3 the candidate deltas come from that alpha's arms, so
    the subpack-0 arms there are taken out (the pick moves to delta 0.002,
    where the plan packs nothing: subpack 0)."""
    monkeypatch.setenv("BSMR_CACHE_DIR", str(sweep_log.parent / "cache"))
    records = json.loads((sweep_log.parent / "arms.json").read_text())
    kw = dict(ks=(128,), auto_alpha=auto_alpha, costs=tat.V5E_COSTS,
              echo=lambda _: None)
    if auto_alpha:
        pick = check_autotune.check(check_autotune.runs_from_records(
            records), tds.SUITE, **kw)["rows"][0]["picked"]
        drop = [r for r in records
                if [r["alpha"], r["delta"], r["subpack"]] == pick]
    else:
        drop = [r for r in records if r["alpha"] == 0.3
                and r["subpack"] == 0]
    records = [r for r in records if r not in drop]
    runs = check_autotune.runs_from_records(records)
    got = check_autotune.check(runs, tds.SUITE, **kw)
    picked = got["rows"][0]["picked"]
    assert got["rows"][0]["fraction"] is None
    assert "timed_outside_grid" not in got["rows"][0]
    got = check_autotune.check(runs, tds.SUITE, time_outside_grid="cpu",
                               **kw)
    row = got["rows"][0]
    assert row["picked"] == picked and row["timed_outside_grid"]
    assert row["picked_gflops"] > 0 and row["fraction"] > 0
    assert got["min_fraction"] == row["fraction"]
    arms, out = tmp_path / "arms.json", tmp_path / "rows.json"
    arms.write_text(json.dumps(records))
    assert check_autotune.main(
        ["--arms", str(arms), "--ks", "128", "--out", str(out),
         "--time-outside-grid", "--device", "cpu"]
        + (["--auto-alpha"] if auto_alpha else [])) == 0
    (row,) = json.loads(out.read_text())["rows"]
    assert row["picked"] == picked and row["timed_outside_grid"]
    assert row["fraction"] > 0


# ---------------------------------------------------------------------------
# audit, tier probe cells, refit: one replica-suite log root
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def replica_root(tmp_path_factory):
    """``bench.replica_suite`` on the CPU over the smallest manifest
    replica at K=32 and K=128, ``--configs 0.002:0 0.006:0``, into
    ``<root>/logs_k32`` and ``<root>/logs_k128``."""
    root = tmp_path_factory.mktemp("replicas")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BSMR_CACHE_DIR", str(root / "cache"))
        for k in ("32", "128"):
            assert replica_suite.main(
                REPLICA + ["-k", k, "--configs", "0.002:0", "0.006:0",
                           "--dataset-dir", str(root / "data"),
                           "--log-dir", str(root / f"logs_k{k}"),
                           "--out-dir", str(root / "out"),
                           "--stop-file", str(root / "stop"),
                           "--device", "cpu"]) == 0
    return root


@pytest.fixture
def audits(replica_root, tmp_path, monkeypatch, capsys):
    """The JAX script's audit and the port's main's, of the same logs,
    both priced with V5E_COSTS."""
    monkeypatch.setenv("BSMR_CACHE_DIR", str(replica_root / "cache"))
    common = ["--log-root", str(replica_root),
              "--dataset-dir", str(replica_root / "data"), "--subpack", "0"]
    monkeypatch.setattr(sys, "argv", ["audit_cost_model.py", *common,
                                      "--out", str(tmp_path / "jax.json")])
    assert _script("audit_cost_model").main() == 0
    assert audit_cost_model.main(common + [
        "--out", str(tmp_path / "torch.json"), "--device", "cpu"]) == 0
    capsys.readouterr()
    return (json.loads((tmp_path / "jax.json").read_text()),
            json.loads((tmp_path / "torch.json").read_text()),
            tmp_path / "torch.json")


def test_parse_records_equal(replica_root):
    got = audit_cost_model.parse_records(str(replica_root))
    assert got == _script("audit_cost_model").parse_records(
        str(replica_root))
    assert sorted({r["k"] for r in got}) == [32, 128]
    assert {r["delta"] for r in got} == {0.002, 0.006}


def test_audit_equal_to_jax_main(audits, replica_root, monkeypatch):
    """Rows, per_k, per_regime_k and worst of the port's audit equal the
    JAX script's; audit() on parsed records gives the same without a
    file."""
    want, got, _ = audits
    assert got == want
    assert want["cells"] == len(want["rows"]) >= 4
    assert set(want["per_k"]) == {"32", "128"}
    monkeypatch.setenv("BSMR_CACHE_DIR", str(replica_root / "cache"))
    again = audit_cost_model.audit(
        audit_cost_model.parse_records(str(replica_root)),
        audit_cost_model.replica_planner(str(replica_root / "data"), 0),
        tat.V5E_COSTS, echo=lambda _: None)
    assert json.loads(json.dumps(again)) == want


@pytest.mark.parametrize("top", (1, 3, 10))
def test_pick_cells_equal(audits, top):
    want, _, _ = audits
    assert probe_tier_calibration.pick_cells(want, top) == \
        _script("probe_tier_calibration").pick_cells(want, top)


def _printed_fit(text):
    """defaults / refit quality and the table from the JAX script's
    stdout."""
    lines = text.splitlines()
    defaults = json.loads(lines[1].split(":", 1)[1])
    refit = json.loads(lines[2].split(":", 1)[1])
    end = lines.index("}")
    return defaults, refit, json.loads("\n".join(lines[3:end + 1]))


def test_fit_equal_to_jax_script(audits, tmp_path, monkeypatch, capsys):
    """The refit table and both qualities equal the JAX script's printed
    JSON to 1e-12; the cache each writes merges into the same table."""
    _, _, audit_file = audits
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(sys, "argv", ["fit_costs_from_audit.py", "--audit",
                                      str(audit_file), "--write-cache",
                                      "Card X"])
    assert _script("fit_costs_from_audit").main() == 0
    defaults, refit, table = _printed_fit(capsys.readouterr().out)
    got = fit_costs_from_audit.fit(json.loads(audit_file.read_text())["rows"])
    _close(got["table"], table)
    _close(got["quality"], {"defaults": defaults, "refit": refit})
    assert all(math.isfinite(v) for v in table.values())

    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path / "torch"))
    assert fit_costs_from_audit.main(["--audit", str(audit_file),
                                      "--write-cache", "Card X",
                                      "--device", "cpu"]) == 0
    printed = _printed_fit(capsys.readouterr().out)
    _close(printed, (defaults, refit, table))
    with open(tmp_path / "jax" / "tier_costs_Card_X.json") as f:
        jax_written = json.load(f)
    with open(tat._cache_path("Card X")) as f:
        mine = json.load(f)
    assert "fixed_us" not in mine
    _close(mine, jax_written)
    _close(tat._merge_costs(mine), jat._merge_costs(jax_written))


# ---------------------------------------------------------------------------
# predict_scaling, prewarm
# ---------------------------------------------------------------------------

def _two_small(ds):
    return (("banded_mesh_32k", lambda: ds.banded(2048, 40000, 48, seed=44)),
            ("community_20k", lambda: ds.community(2048, 30000, 8,
                                                   seed=47)))


def test_predict_scaling_equal_to_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(jds, "SUITE", _two_small(jds))
    monkeypatch.setattr(tds, "SUITE", _two_small(tds))
    monkeypatch.setattr(sys, "argv", ["predict_scaling.py",
                                      str(tmp_path / "jax.json")])
    assert _script("predict_scaling").main() == 0
    jax_out = capsys.readouterr().out
    assert predict_scaling.main([str(tmp_path / "torch.json"),
                                 "--device", "cpu"]) == 0
    assert capsys.readouterr().out == jax_out
    want = json.loads((tmp_path / "jax.json").read_text())
    _close(json.loads((tmp_path / "torch.json").read_text()), want)
    assert set(want) == {"assumptions", "banded_mesh_32k", "community_20k"}


def test_prewarm_writes_the_jax_cache_files(tmp_path, monkeypatch, capsys):
    """The same cache file names and permutations as the JAX script, each
    into its own BSMR_CACHE_DIR; a second run adds nothing."""
    script = _script("prewarm_reorder_cache")
    monkeypatch.setattr(script, "tunnel_up", lambda *a: False)
    common = REPLICA + ["--alphas", "0.1", "0.3",
                        "--dataset-dir", str(tmp_path / "data"),
                        "--stop-file", str(tmp_path / "stop")]
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(sys, "argv", ["prewarm_reorder_cache.py", *common])
    assert script.main() == 0
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path / "torch"))
    assert prewarm_reorder_cache.main(common + ["--device", "cpu"]) == 0
    assert "prewarm complete: 2 new entries" in capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 2
    for name in names:
        with np.load(tmp_path / "torch" / name) as a, \
                np.load(tmp_path / "jax" / name) as b:
            for key in ("row_perm", "cluster_ids", "num_clusters"):
                np.testing.assert_array_equal(a[key], b[key])
    assert prewarm_reorder_cache.main(common + ["--device", "cpu"]) == 0
    assert "prewarm complete: 0 new entries" in capsys.readouterr().out
    (tmp_path / "stop").write_text("")
    done, visited = prewarm_reorder_cache.prewarm(
        [object()], [0.1], str(tmp_path / "data"), str(tmp_path / "stop"),
        echo=lambda _: None)
    assert (done, visited) == (0, 0)


# ---------------------------------------------------------------------------
# The device tools on the CPU: what chip_smoke.py and a chip run call
# ---------------------------------------------------------------------------

def test_probe_tier_calibration_cpu(audits, replica_root, tmp_path,
                                    monkeypatch):
    """main over the audit on the CPU: one row per picked cell with its
    tier split and byte counts, then the fat-group sweep row where a
    cell's dense tier holds more than half its time."""
    _, _, audit_file = audits
    monkeypatch.setenv("BSMR_CACHE_DIR", str(replica_root / "cache"))
    out = tmp_path / "tiers.json"
    assert probe_tier_calibration.main([
        "--audit", str(audit_file), "--out", str(out), "--top", "2",
        "--dataset-dir", str(replica_root / "data"), "--device", "cpu"]) == 0
    rows = json.loads(out.read_text())
    cells = [r for r in rows if "fat_group_sweep" not in r]
    assert len(cells) == 2
    for r in cells:
        assert r["tiles"] >= 0 and r["dense_dma_mb"] >= 0
        assert float(r["tier_residual_ms"]) >= 0
    for r in rows[len(cells):]:
        assert r["fat_group_sweep"] and r["torch_dense_ms"] > 0


def test_probe_refine_pick_cpu(monkeypatch, tmp_path):
    """probe_cell on the CPU: the 18-arm sweep, and the host and refined
    picks (on the CPU the refine keeps the estimate order) each a
    fraction of the swept best."""
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path))
    csr = tds.community(1024, 12000, 8, seed=47)
    lines = []
    row = probe_refine_pick.probe_cell("community_20k", csr, 32, "cpu",
                                       iterations=1, echo=lines.append)
    assert len(lines) == len(probe_refine_pick.ALPHAS) * len(
        probe_refine_pick.DELTAS) * len(probe_refine_pick.SUBS)
    for pick in ("host_pick", "refined_pick"):
        assert 0 < row[pick][2] <= 1.0
    assert row["host_pick"][0] == row["refined_pick"][0]


def test_probe_refine_pick_on_fewer_alphas_cpu(monkeypatch, tmp_path):
    """probe_cell(alphas=...) sweeps and picks over those alphas only."""
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path))
    csr = tds.community(1024, 12000, 8, seed=47)
    lines = []
    row = probe_refine_pick.probe_cell("community_20k", csr, 32, "cpu",
                                       iterations=1, echo=lines.append,
                                       alphas=(0.1, 0.3))
    assert len(lines) == 2 * len(probe_refine_pick.DELTAS) * len(
        probe_refine_pick.SUBS)
    assert all(" a=0.5 " not in line for line in lines)
    for pick in ("host_pick", "refined_pick"):
        assert row[pick][0][0] in (0.1, 0.3)
        assert 0 < row[pick][2] <= 1.0


def test_profile_tiers_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(tds, "SUITE", _two_small(tds))
    assert profile_tiers.main(["32", "community_20k", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith("community_20k d=0.02 K=32: ")
    assert "| res " in line and "overlap" in line
    recs = profile_tiers.profile(["banded_mesh_32k"], 32, "cpu",
                                 echo=lambda _: None)
    assert len(recs) == 1 and recs[0]["device"] == "cpu"
    assert set(recs[0]["tier_ms"]) == {"dense", "packed", "gathered",
                                      "residual"}


def test_run_weak_scaling_cpu(tmp_path):
    out = tmp_path / "weak.json"
    assert run_weak_scaling.main(["--counts", "1", "2", "--out", str(out),
                                  "--device", "cpu"]) == 0
    payload = json.loads(out.read_text())
    assert payload["devices"] == ["cpu", "cpu"]
    assert set(payload["per_device"]) == {"1", "2"}
    for rec in payload["per_device"].values():
        assert rec["ms"] > 0 and len(set(map(tuple,
                                            rec["shard_shapes"]))) == 1
    assert "not device metrics" in payload["note"]


# ---------------------------------------------------------------------------
# The device rule and the import rule, for all nine
# ---------------------------------------------------------------------------

def test_calibrate_raises_without_a_card(monkeypatch):
    """calibrate() resolves its device like every entry point: no quiet
    CPU run where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tat.calibrate()
    assert tat._CALIBRATED is None


@pytest.mark.parametrize("name", TOOLS)
def test_tool_defaults_to_the_card(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(tmp_path / "absent.log")] if name == "check_autotune" else []
    mod = importlib.import_module(f"bsmr_sddmm_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


@pytest.mark.parametrize("name", TOOLS)
def test_tool_help(name, capsys):
    mod = importlib.import_module(f"bsmr_sddmm_tpu_torch.tools.{name}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


def test_tools_import_no_jax():
    """No tools module imports jax, the JAX package or scripts/, and each
    runs its main under ``python -m``."""
    root = os.path.join(REPO, "bsmr_sddmm_tpu_torch", "tools")
    files = sorted(f for f in os.listdir(root) if f.endswith(".py"))
    assert files == sorted(["__init__.py"] + [f"{t}.py" for t in TOOLS])
    for f in files:
        with open(os.path.join(root, f)) as fh:
            tree = ast.parse(fh.read())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                mods.add(node.module or "")
        top = {m.split(".")[0] for m in mods}
        assert not top & {"jax", "jaxlib", "bsmr_sddmm_tpu", "scripts"}, f
        if f != "__init__.py":
            assert any(isinstance(n, ast.If) and "__main__" in ast.dump(n)
                       for n in tree.body), f
