"""The port's harness against the JAX package's: the log analyzer, the
dataset tools, the suite runner, the profiling hooks, host-memory tuning and
the SuiteSparse replicas (``tests/test_harness.py`` mirrored on
``bsmr_sddmm_tpu_torch``). Each test hands the same inputs to both packages
and compares the results exactly: the same CSVs and files byte for byte,
the same replica CSRs bit for bit."""

import dataclasses
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_threads  # noqa: F401  (this worker's thread budget)

import bsmr_sddmm_tpu.bench.analyze as janalyze
import bsmr_sddmm_tpu.bench.plot as jplot
import bsmr_sddmm_tpu.datatools as jdt
import bsmr_sddmm_tpu.replicas as jrep

import bsmr_sddmm_tpu_torch.bench.analyze as tanalyze
import bsmr_sddmm_tpu_torch.bench.plot as tplot
import bsmr_sddmm_tpu_torch.datatools as tdt
import bsmr_sddmm_tpu_torch.replicas as trep
from bsmr_sddmm_tpu_torch.formats import load_matrix, random_mask, save_mtx
from bsmr_sddmm_tpu_torch.utils.logger import RunLog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_log(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(r.to_text())


def _quiet(*_args):
    pass


# ---------------------------------------------------------------------------
# Analyzer
# ---------------------------------------------------------------------------

def test_analyzer_best_per_matrix_and_speedups(tmp_path):
    """test_harness.py:65 on the port, and the same Analysis and a
    byte-equal results CSV from both packages' analyzers."""
    logs = tmp_path / "logs"
    logs.mkdir()
    r_slow = RunLog(file="m1.mtx", m=100, n=100, k=32, nnz=1000,
                    alpha=0.1, delta=0.3, sddmm_ms=2.0)
    r_fast = RunLog(file="m1.mtx", m=100, n=100, k=32, nnz=1000,
                    alpha=0.3, delta=0.5, sddmm_ms=1.0,
                    check_result="pass")
    r_m2 = RunLog(file="m2.mtx", m=200, n=300, k=32, nnz=5000,
                  alpha=0.3, delta=0.002, sddmm_ms=0.5,
                  check_result="fail",
                  extras={"tier_dense_ms": "0.2", "tier_gathered_ms": "0.1",
                          "tier_residual_ms": "0.1",
                          "tier_overlap_efficiency": "0.8"})
    r_base = RunLog(file="m1.mtx", m=100, n=100, k=32, nnz=1000,
                    backend="gather_dot", sddmm_ms=4.0)
    r_bcoo = RunLog(file="m2.mtx", m=200, n=300, k=32, nnz=5000,
                    backend="bcoo", sddmm_ms=1.5, check_result="pass")
    _write_log(logs / "bsmr.log", [r_slow, r_fast, r_m2])
    _write_log(logs / "base.log", [r_base, r_bcoo])
    paths = [str(logs / "bsmr.log"), str(logs / "base.log")]

    best = tanalyze.best_per_matrix(tanalyze.parse_log_files(paths))
    assert best[("m1.mtx", 32, "bsmr")].delta == 0.5
    a = tanalyze.analyze_logs(paths, k=32)
    assert len(a.rows) == 2
    assert a.rows[0]["alpha"] == 0.3
    assert a.speedup_geomean["gather_dot"] == pytest.approx(4.0)
    assert a.accuracy["bsmr"] == 0.5
    assert a.mode_delta in (0.5, 0.002)

    ja = janalyze.analyze_logs(paths, k=32)
    assert (a.rows, a.geomean, a.speedup_geomean, a.accuracy, a.mode_alpha,
            a.mode_delta) == (ja.rows, ja.geomean, ja.speedup_geomean,
                              ja.accuracy, ja.mode_alpha, ja.mode_delta)
    got = tanalyze.write_results_csv(a, str(tmp_path / "torch"))
    want = janalyze.write_results_csv(ja, str(tmp_path / "jax"))
    assert open(got).read() == open(want).read()
    assert "bsmr" in open(got).read() and "gather_dot" in open(got).read()


def test_analyzer_hybrid_csv(tmp_path):
    """test_harness.py:97 on the port; the hybrid CSV byte-equal to the
    JAX package's."""
    logs = tmp_path / "logs"
    logs.mkdir()
    _write_log(logs / "sweep.log", [
        RunLog(file="m.mtx", k=32, nnz=1000, delta=0.0, sddmm_ms=2.0),
        RunLog(file="m.mtx", k=32, nnz=1000, delta=0.3, sddmm_ms=1.0),
        RunLog(file="m.mtx", k=32, nnz=1000, delta=1.1, sddmm_ms=3.0),
        RunLog(file="n.mtx", k=32, nnz=800, delta=0.3, sddmm_ms=1.0),
    ])
    paths = [str(logs / "sweep.log")]
    path = tanalyze.write_hybrid_csv(paths, 32, str(tmp_path / "torch"))
    rows = open(path).read().splitlines()
    assert len(rows) == 3
    hybrid, dense, resid = rows[1].split(",")[2:5]
    assert float(hybrid) > float(dense) > float(resid)
    want = janalyze.write_hybrid_csv(paths, 32, str(tmp_path / "jax"))
    assert open(path).read() == open(want).read()


def test_analyzer_baseline_keys_equal():
    assert tanalyze._BASELINE_KEYS == janalyze._BASELINE_KEYS


def test_analyze_cli_writes_csv(tmp_path, capsys):
    logs = tmp_path / "logs"
    logs.mkdir()
    _write_log(logs / "a.log", [
        RunLog(file="m.mtx", k=64, nnz=1000, alpha=0.3, delta=0.3,
               sddmm_ms=1.0, check_result="pass")])
    assert tanalyze.main([str(logs / "*.log"), "-o",
                          str(tmp_path / "out")]) == 0
    assert "K=64: 1 matrices" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "out" / "results_64.csv")


# ---------------------------------------------------------------------------
# Dataset tools
# ---------------------------------------------------------------------------

def test_matrix_filter_semantics():
    big = random_mask(10000, 10000, 110000, seed=1)
    small = random_mask(100, 100, 500, seed=2)
    assert tdt.matrix_is_valid(big) and jdt.matrix_is_valid(big)
    assert not tdt.matrix_is_valid(small)
    assert not jdt.matrix_is_valid(small)
    assert (tdt.MIN_DIM, tdt.MIN_NNZ) == (jdt.MIN_DIM, jdt.MIN_NNZ)


def test_filter_and_unfilter_roundtrip(tmp_path):
    """test_harness.py:125 on the port; and a kept matrix is rewritten
    (values 1) to the same bytes as the JAX package's filter writes."""
    dirs = {}
    for tag, mod in (("torch", tdt), ("jax", jdt)):
        d = tmp_path / tag
        d.mkdir()
        save_mtx(str(d / "small.mtx"), random_mask(64, 64, 200, seed=3))
        save_mtx(str(d / "big.mtx"),
                 random_mask(10000, 10000, 110000, seed=1))
        kept = mod.filter_dataset(str(d), echo=_quiet)
        assert kept == [str(d / "big.mtx")]
        assert os.path.exists(d / "excluded" / "small.mtx")
        dirs[tag] = d
    assert filecmp.cmp(dirs["torch"] / "big.mtx", dirs["jax"] / "big.mtx",
                       shallow=False)
    assert tdt.unfilter_dataset(str(dirs["torch"]), echo=_quiet) == 1
    assert os.path.exists(dirs["torch"] / "small.mtx")
    assert (load_matrix(str(dirs["torch"] / "big.mtx")).values == 1).all()


def test_smtx_and_npz_conversions(tmp_path):
    csr = random_mask(64, 80, 300, seed=4)
    outs = {}
    for tag, mod in (("torch", tdt), ("jax", jdt)):
        d = tmp_path / tag
        d.mkdir()
        smtx = d / "m.smtx"
        with open(smtx, "w") as f:
            f.write(f"{csr.rows}, {csr.cols}, {csr.nnz}\n")
            f.write(" ".join(map(str, csr.row_offsets)) + "\n")
            f.write(" ".join(map(str, csr.col_indices)) + "\n")
        mtx = mod.convert_smtx_to_mtx(str(smtx))
        outs[tag] = (mtx, mod.load_npz(mod.convert_mtx_to_npz(mtx)))
    assert filecmp.cmp(outs["torch"][0], outs["jax"][0], shallow=False)
    rt = load_matrix(outs["torch"][0])
    assert rt.nnz == csr.nnz
    np.testing.assert_array_equal(rt.col_indices, csr.col_indices)
    for field in ("row_offsets", "col_indices", "values"):
        np.testing.assert_array_equal(getattr(outs["torch"][1], field),
                                      getattr(outs["jax"][1], field))
    assert (outs["torch"][1].rows, outs["torch"][1].cols) == (64, 80)


def test_make_matrices_list(tmp_path):
    d = tmp_path / "ds"
    d.mkdir()
    save_mtx(str(d / "a.mtx"), random_mask(32, 32, 64, seed=5))
    save_mtx(str(d / "b.mtx"), random_mask(32, 32, 64, seed=6))
    out, ref = tmp_path / "list.txt", tmp_path / "ref.txt"
    assert tdt.make_matrices_list(str(d), str(out)) == 2
    assert jdt.make_matrices_list(str(d), str(ref)) == 2
    lines = open(out).read().splitlines()
    assert len(lines) == 2 and lines[0].endswith("a.mtx")
    assert open(out).read() == open(ref).read()


# ---------------------------------------------------------------------------
# Suite runner
# ---------------------------------------------------------------------------

def test_runner_loop_in_process(tmp_path, monkeypatch):
    """test_harness.py:196 on the port: run accounting, baseline fan-out,
    timeout rc propagation, and the device passed on to every run."""
    from bsmr_sddmm_tpu_torch.bench import runner

    calls = []

    def fake_matrix(path, log_dir, k=32, alpha=0.3, delta=0.3, **kw):
        calls.append(("bsmr", path, k, alpha, delta, kw["device"],
                      kw["backend"]))
        return 124 if "hang" in path else 0

    def fake_baseline(path, log_dir, baseline, k=32, **kw):
        calls.append((baseline, path, k, kw["device"]))
        return 0

    monkeypatch.setattr(runner, "run_matrix", fake_matrix)
    monkeypatch.setattr(runner, "run_baseline_matrix", fake_baseline)
    statuses = runner.run_suite(
        ["a.mtx", "hang.mtx"], str(tmp_path), ks=(32, 64),
        alphas=(0.1, 0.3), deltas=(0.3,), baselines=("gather_dot",),
        device="cpu", echo=_quiet)
    assert len([s for s in statuses if s["method"] == "bsmr"]) == 8
    assert len([s for s in statuses if s["method"] == "gather_dot"]) == 4
    assert {s["returncode"] for s in statuses
            if s["file"] == "hang.mtx" and s["method"] == "bsmr"} == {124}
    assert all(s["returncode"] == 0 for s in statuses
               if s["file"] == "a.mtx")
    assert {c[5] for c in calls if c[0] == "bsmr"} == {"cpu"}
    assert {c[6] for c in calls if c[0] == "bsmr"} == {"auto"}
    assert {c[3] for c in calls if c[0] == "gather_dot"} == {"cpu"}


def test_runner_command_lines(tmp_path, monkeypatch):
    """Each run is the port's CLI (or a baseline on the port's modules) in
    a fresh interpreter, with --device passed on only when given; a
    timeout reads as rc 124."""
    from bsmr_sddmm_tpu_torch.bench import runner

    cmds = []

    def fake_run(cmd, timeout):
        cmds.append(cmd)
        if "slow" in " ".join(cmd):
            raise subprocess.TimeoutExpired(cmd, timeout)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(runner.subprocess, "run", fake_run)
    assert runner.run_matrix("m.mtx", "logs", k=64, device="cpu",
                             validate=True) == 0
    assert cmds[-1][1:3] == ["-m", "bsmr_sddmm_tpu_torch.cli"]
    assert cmds[-1][-3:] == ["--device", "cpu", "--validate"]
    assert "--backend" in cmds[-1] and "auto" in cmds[-1]
    runner.run_matrix("m.mtx", "logs")
    assert "--device" not in cmds[-1]
    assert runner.run_baseline_matrix("m.mtx", "logs", "gather_dot",
                                      device="cpu") == 0
    code = cmds[-1][2]
    assert "bsmr_sddmm_tpu_torch.baselines" in code
    assert "device='cpu'" in code and "bsmr_sddmm_tpu." not in code
    assert runner.run_matrix("slow.mtx", "logs") == 124


def test_runner_end_to_end(tmp_path):
    """The real process isolation: the runner's CLI run and baseline run on
    a tiny .mtx, each in its own interpreter on the CPU (--device cpu),
    logs that the analyzer reads with both checks passed."""
    d = tmp_path / "ds"
    d.mkdir()
    save_mtx(str(d / "t.mtx"), random_mask(256, 256, 4000, seed=7,
                                           block_rows=16, block_cols=64))
    (tmp_path / "list.txt").write_text(str(d / "t.mtx") + "\n")
    logdir = tmp_path / "logs"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "bsmr_sddmm_tpu_torch.bench.runner",
         "-f", str(tmp_path / "list.txt"), "-l", str(logdir), "-k", "32",
         "--baselines", "gather_dot", "--validate", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2/2 runs ok" in proc.stdout
    logfiles = sorted(os.listdir(logdir))
    assert any(f.startswith("BSMR_") for f in logfiles)
    assert any(f.startswith("gather_dot_") for f in logfiles)
    paths = [str(logdir / f) for f in logfiles]
    a = tanalyze.analyze_logs(paths, k=32)
    assert a.accuracy.get("bsmr", 0) == 1.0
    assert a.accuracy.get("gather_dot", 0) == 1.0
    assert a.rows[0]["file"] == "t.mtx" and a.rows[0]["bsmr"] > 0


# ---------------------------------------------------------------------------
# Profiling hooks and host memory
# ---------------------------------------------------------------------------

def test_phase_timer_accumulates():
    from bsmr_sddmm_tpu_torch.utils.profiling import phase_timer
    sink = {}
    with phase_timer(sink, "reorder"):
        pass
    first = sink["reorder"]
    with pytest.raises(KeyError):
        with phase_timer(sink, "reorder"):
            raise KeyError("the time still counts")
    assert sink["reorder"] >= first >= 0.0


def test_profiling_trace_writes_chrome_trace(tmp_path):
    """trace() wraps torch.profiler (jax.profiler in the JAX package) and
    leaves a Chrome trace in log_dir with the enclosed work in it."""
    import torch
    from bsmr_sddmm_tpu_torch.utils.profiling import trace
    x = torch.ones(64, 64)
    with trace(str(tmp_path / "tr")) as path:
        torch.mm(x, x)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_tune_malloc_applies_on_glibc():
    from bsmr_sddmm_tpu_torch.utils.hostmem import rss_gb, tune_malloc
    assert tune_malloc() is True
    a = np.full((1024, 32, 128), 7, np.int32)
    assert int(a[-1, -1, -1]) == 7
    assert rss_gb() > 0.0


# ---------------------------------------------------------------------------
# Replicas
# ---------------------------------------------------------------------------

def test_manifest_csv_byte_identical():
    assert filecmp.cmp(trep._MANIFEST, jrep._MANIFEST, shallow=False)
    assert [dataclasses.astuple(s) for s in trep.load_manifest()] == \
        [dataclasses.astuple(s) for s in jrep.load_manifest()]


def test_replica_manifest_and_generators():
    """test_harness.py:536 on the port, and select_suite equal to the JAX
    package's."""
    specs = trep.load_manifest()
    assert len(specs) == 503
    assert all(s.ref_bsmr_gflops.get(128, 0) > 0 for s in specs)
    sel = trep.select_suite(count=30, max_nnz=2_000_000)
    assert len(sel) >= 30
    assert {s.regime for s in sel} == {"mesh", "opt", "graph"}
    assert [s.name for s in sel] == [
        s.name for s in jrep.select_suite(count=30, max_nnz=2_000_000)]
    for s in sel[:2]:
        csr = trep.make_replica(s)
        assert (csr.rows, csr.cols) == (s.m, s.n)
        assert abs(csr.nnz - s.nnz) / s.nnz < 0.25, (s.name, csr.nnz)


# one spec per generator: banded (mesh), latent community (opt), the
# block-diagonal TSOPF family (opt) and R-MAT (graph)
REPLICA_SPECS = ("skirt", "psse0", "TSOPF_RS_b39_c7",
                 "vsp_barth5_1Ksep_50in_5Kout")


@pytest.mark.parametrize("name", REPLICA_SPECS)
def test_make_replica_bit_identical(name):
    tspec = {s.name: s for s in trep.load_manifest()}[name]
    jspec = {s.name: s for s in jrep.load_manifest()}[name]
    got, want = trep.make_replica(tspec), jrep.make_replica(jspec)
    assert (got.rows, got.cols) == (want.rows, want.cols)
    for field in ("row_offsets", "col_indices", "values"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_opt_replica_structure_fidelity():
    """test_harness.py:413 on the port: the TSOPF replica reproduces the
    real matrix's 16x16 dense structure within 2x."""
    from tests.test_harness import _tile16_stats
    spec = {s.name: s for s in trep.load_manifest()}["TSOPF_FS_b162_c1"]
    assert spec.ref_dense_coverage is not None
    assert spec.ref_dense_coverage > 0.5
    csr = trep.make_replica(spec)
    assert abs(csr.nnz - spec.nnz) / spec.nnz < 0.35
    cov, avg_den, _ = _tile16_stats(csr)
    assert cov >= spec.ref_dense_coverage / 2, (cov, spec)
    assert avg_den >= spec.ref_avg_density / 2, (avg_den, spec)


def test_make_replica_cached_roundtrip(tmp_path):
    """test_harness.py:565 on the port: a cache hit is bit-identical, a
    corrupt entry is regenerated, and the JAX package reads the same
    entry."""
    spec = min(trep.load_manifest(), key=lambda s: s.nnz)
    d = str(tmp_path)
    first = trep.make_replica_cached(spec, d)
    again = trep.make_replica_cached(spec, d)
    np.testing.assert_array_equal(first.row_offsets, again.row_offsets)
    np.testing.assert_array_equal(first.col_indices, again.col_indices)
    jspec = {s.name: s for s in jrep.load_manifest()}[spec.name]
    shared = jrep.make_replica_cached(jspec, d)
    np.testing.assert_array_equal(first.col_indices, shared.col_indices)
    path = tmp_path / f"{spec.name}.npz"
    path.write_bytes(b"not an npz")
    rebuilt = trep.make_replica_cached(spec, d)
    np.testing.assert_array_equal(first.col_indices, rebuilt.col_indices)


# ---------------------------------------------------------------------------
# Plots
# ---------------------------------------------------------------------------

def test_rolling_geomean_identical():
    rng = np.random.default_rng(3)
    xs = list(rng.integers(1, 10**6, 40).astype(float))
    ys = list(rng.random(40) * 100)
    ys[5] = 0.0
    assert tplot._rolling_geomean(xs, ys, 5) == \
        jplot._rolling_geomean(xs, ys, 5)


def test_plots_write_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    csv_path = tmp_path / "results_128.csv"
    csv_path.write_text("file,M,N,NNZ,sparsity,alpha,delta,bsmr,gather_dot\n"
                        "a.mtx,10,10,100000,0.9,0.3,0.3,500,100\n"
                        "b.mtx,10,10,200000,0.9,0.3,0.3,700,90\n")
    hyb = tmp_path / "results_hybrid_128.csv"
    hyb.write_text("file,NNZ,hybrid,dense_only,residual_only\n"
                   "a.mtx,100000,500,300,100\n")
    log = tmp_path / "r.log"
    _write_log(log, [RunLog(file="a.mtx", k=128, nnz=100000,
                            sddmm_ms=0.5, row_reordering_ms=20.0,
                            pack_ms=5.0)])
    for out in (tplot.plot_sddmm(str(csv_path), str(tmp_path / "s.png")),
                tplot.plot_hybrid(str(hyb), str(tmp_path / "h.png")),
                tplot.plot_reordering_overhead([str(log)],
                                               str(tmp_path / "r.png"))):
        assert os.path.getsize(out) > 0
