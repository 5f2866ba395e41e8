"""The port's bench against the JAX package's: ``bench/suite.py`` against
``bench.py`` and ``bench/replica_suite.py``'s summary against
``scripts/analyze_replicas.py``, on the CPU at a tiny size.

Both suites run on the same stand-in SUITE (two small matrices under
R4_BEST names, made by each package's own, identical, generators): the
same cells and arms, the same per-arm dense/gathered/residual nnz, the
same result keys and matrices per K. GFLOPS are not compared (CPU times).
"""

import importlib.util
import json
import os
import re

import pytest

import _torch_threads  # noqa: F401  (this worker's thread budget)

import bsmr_sddmm_tpu.datasets as jds
import bsmr_sddmm_tpu.utils.compilecache as jcompilecache

import bsmr_sddmm_tpu_torch.datasets as tds
from bsmr_sddmm_tpu_torch.bench import replica_suite, suite
from bsmr_sddmm_tpu_torch.tools import check_autotune
from bsmr_sddmm_tpu_torch.utils.logger import RunLog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = ("metric", "value", "unit", "vs_baseline", "per_k_geomean",
          "per_k_vs_baseline", "per_k_geomean_fp32out", "matrices_per_k")
# an arm line of bench.py, which the port's starts with
ARM = re.compile(r"^# (\S+) a=(\S+) d=(\S+) k=(\d+)( dt=f16)?: \S+ GFLOPS "
                 r"\(\S+ ms, dense (\d+), gath (\d+), res (\d+), "
                 r"fill (\S+)\)")


def _load_bench_py():
    spec = importlib.util.spec_from_file_location(
        "bench_py", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny(ds):
    """Two small matrices under SUITE names: community_20k's arms take
    subpack 12 and an fp16 sibling at K=128, banded_mesh_64k's alpha 0.5
    at K=256 and an fp16 sibling at K=128."""
    return (("community_20k", lambda: ds.community(2048, 60000, 8, seed=47)),
            ("banded_mesh_64k", lambda: ds.banded(3000, 90000, 48, seed=49)))


def _arms(text):
    return sorted(m.groups("") for m in map(ARM.match, text.splitlines())
                  if m)


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture
def tiny_suites(monkeypatch, tmp_path):
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("BENCH_MATRICES", "community_20k,banded_mesh_64k")
    monkeypatch.setattr(jds, "SUITE", _tiny(jds))
    monkeypatch.setattr(tds, "SUITE", _tiny(tds))
    monkeypatch.setattr(jcompilecache, "enable_compile_cache",
                        lambda *a, **k: None)
    # the port's enable_compile_cache() sets it; put back after the test
    monkeypatch.setenv("BSMR_TORCH_KERNEL_DIR", str(tmp_path / "kernels"))


@pytest.mark.parametrize("table", ("KS", "ALPHAS", "CONFIGS", "N_TRANSFER",
                                   "MAX_PLAN_BYTES",
                                   "BASELINE_GEOMEAN_GFLOPS", "R4_BEST"))
def test_suite_tables_equal_bench_py(table):
    assert getattr(suite, table) == getattr(_load_bench_py(), table)


def test_suite_against_bench_py(tiny_suites, capsys):
    """The whole slice: bench.main() (JAX, CPU) and the port's main
    (--device cpu) on the same stand-in suite print the same arms with the
    same tier nnz and the same result keys and matrices per K; the port
    validates each (matrix, K)'s fp32 arm and every fp16 arm, all pass."""
    assert _load_bench_py().main() == 0
    jax_out = capsys.readouterr()
    assert suite.main(["--device", "cpu"]) == 0
    out = capsys.readouterr()
    want, got = _last_json(jax_out.out), _last_json(out.out)
    assert tuple(got) == SCHEMA == tuple(want)
    assert got["metric"] == want["metric"] and got["unit"] == "GFLOPS"
    assert got["matrices_per_k"] == want["matrices_per_k"] == {
        "32": 2, "64": 2, "128": 2, "256": 2}
    for key in SCHEMA[4:]:
        assert set(got[key]) == set(want[key])
    arms = _arms(out.err)
    assert arms == _arms(jax_out.err)
    assert len(arms) == 10   # 8 (matrix, K) cells and 2 fp16 siblings
    checks = re.findall(r"check (\w+)$", out.err, re.M)
    assert checks == ["pass"] * 10
    phases = [ln for ln in out.err.splitlines()
              if ln.startswith("# phases (s): ")]
    assert len(phases) == 1
    for phase in suite.PHASES:
        assert f" {phase} " in phases[0]


def test_suite_plan_guard_falls_back_to_dense(tiny_suites, monkeypatch):
    """bench.py's plan-bytes guard skips every tiled arm; each (matrix, K)
    then runs the dense fallback, validated."""
    monkeypatch.setattr(suite, "MAX_PLAN_BYTES", 0)
    lines = []
    out = suite.run(tds.SUITE[:1], ks=(128,), device="cpu",
                    echo=lines.append)
    assert out["matrices_per_k"] == {"128": 1}
    assert "failed_cells" not in out
    assert any("skipped (plan maps" in ln for ln in lines)
    assert any("dense fallback" in ln and ln.endswith("check pass")
               for ln in lines)


def test_suite_names_failed_cells_and_exits_1(tiny_suites, monkeypatch,
                                              capsys):
    """A validated arm whose check is not pass, and a cell that raises
    twice, are named in failed_cells and main exits 1 after the line; a
    cell that raises once is retried."""
    from bsmr_sddmm_tpu_torch.sddmm import BsmrSddmm
    validate, benchmark = BsmrSddmm._validate, BsmrSddmm.benchmark
    raised = []

    def bad_fp16(self, log, A, B, out):
        validate(self, log, A, B, out)
        if self.config.out_dtype == "float16":
            log.check_result = "fail"

    def flaky(self, A, B, **kw):
        K = A.shape[1]
        if K in (32, 64) and raised.count(K) < (1 if K == 32 else 2):
            raised.append(K)
            raise RuntimeError(f"injected at K={K}")
        return benchmark(self, A, B, **kw)

    monkeypatch.setattr(BsmrSddmm, "_validate", bad_fp16)
    monkeypatch.setattr(BsmrSddmm, "benchmark", flaky)
    monkeypatch.setenv("BENCH_MATRICES", "community_20k")
    assert suite.main(["--device", "cpu"]) == 1
    out = capsys.readouterr()
    line = _last_json(out.out)
    assert line["failed_cells"] == [
        "community_20k:k128:a0.1d0.002s12:f16",
        "community_20k:k64:a0.1d0.002s12"]
    assert tuple(line)[:len(SCHEMA)] == SCHEMA
    assert "RETRY after RuntimeError: injected at K=32" in out.err
    assert "FAILED twice, last RuntimeError: injected at K=64" in out.err
    # K=64 lost its arm, so the dense fallback measured that cell
    assert line["matrices_per_k"] == {"32": 1, "64": 1, "128": 1,
                                      "256": 1}


def test_suite_full_grid_and_extra_arms(tiny_suites, tmp_path):
    """BENCH_FULL_GRID: ALPHAS x CONFIGS at K=128, the best N_TRANSFER
    combos at the other K, an fp16 arm on each K's best combo, the first
    fp32 arm of each K validated. BENCH_EXTRA_ARMS: the autotuner's priced
    pick runs as one more (unvalidated) arm where it differs from
    R4_BEST's. The echoed K=128 group parses (``check_autotune``'s
    positional parse) to the run's own arm records at the log's rounding;
    the K=64 group holds only the transferred combos, which that parse
    cannot attribute."""
    lines, records = [], []
    out = suite.run(tds.SUITE[:1], ks=(128, 64), device="cpu",
                    full_grid=True, echo=lines.append, records=records)
    arms = _arms("\n".join(lines))
    n128 = len(suite.ALPHAS) * len(suite.CONFIGS)
    assert len(arms) == n128 + 1 + suite.N_TRANSFER + 1
    assert sum(a[4] == " dt=f16" for a in arms) == 2
    checks = [ln.rsplit(" ", 1)[-1] for ln in lines if ARM.match(ln)]
    assert checks.count("pass") == 4 and checks.count("untested") == \
        len(arms) - 4
    assert out["matrices_per_k"] == {"128": 1, "64": 1}
    key = (tds.SUITE[0][0], 128)
    grid = check_autotune.runs_from_records(records)[key]
    assert len(grid) == n128
    log = tmp_path / "sweep.log"
    log.write_text("\n".join(lines) + "\n")
    assert check_autotune.parse_log(str(log))[key] == {
        arm: float(f"{g:.0f}") for arm, g in grid.items()}

    lines = []
    pipe = suite.BsmrSddmm(tds.SUITE[0][1](), suite.SddmmConfig(
        k=128, panel_height=32, subpack_min_nnz=12), device="cpu")
    choice = pipe.choose(alpha="auto", k=128)
    out = suite.run(tds.SUITE[:1], ks=(128,), device="cpu",
                    extra_arms=True, echo=lines.append)
    fixed = suite.R4_BEST[("community_20k", 128)][:2]
    want = 2 + ((choice.alpha, choice.plan.delta_used) != fixed)
    assert len(_arms("\n".join(lines))) == want
    assert "failed_cells" not in out


def test_suite_budget_skips_cells(tiny_suites):
    out = suite.run(tds.SUITE, ks=(128, 256), budget_s=-1.0, device="cpu",
                    echo=lambda _: None)
    assert out["budget_skipped"] == ["community_20k:k128",
                                     "community_20k:k256",
                                     "banded_mesh_64k:k128",
                                     "banded_mesh_64k:k256"]
    assert out["matrices_per_k"] == {"128": 0, "256": 0}


def test_suite_needs_k128_and_a_device(tiny_suites, monkeypatch):
    """K=128 is the headline; without a card and without device="cpu" the
    suite raises instead of falling back to the CPU."""
    with pytest.raises(ValueError, match="K=128"):
        suite.run(tds.SUITE, ks=(64,), device="cpu")
    monkeypatch.setattr(suite.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        suite.run(tds.SUITE, echo=lambda _: None)


# ---------------------------------------------------------------------------
# Replica suite
# ---------------------------------------------------------------------------

def _replica_logs(log_dir):
    """Synthetic replica-suite logs over three manifest matrices: two bsmr
    arms each (one validated), gather_dot everywhere, bcoo on one, and an
    fp16 arm in the sibling directory."""
    os.makedirs(log_dir)
    os.makedirs(log_dir + "_fp16")
    specs = {"skirt": (12598, 12598, 104559), "psse0": (26722, 11028,
                                                         102432),
             "vsp_barth5_1Ksep_50in_5Kout": (32212, 32212, 101805)}
    for i, (name, (m, n, nnz)) in enumerate(sorted(specs.items())):
        file = f"{name}.mtx"
        common = dict(file=file, m=m, n=n, k=128, nnz=nnz)
        bsmr = [RunLog(alpha=0.1, delta=0.002, sddmm_ms=0.2 + 0.1 * i,
                       check_result="pass", **common),
                RunLog(alpha=0.3, delta=0.02, sddmm_ms=0.3, **common)]
        with open(os.path.join(log_dir, f"BSMR_{name}.log"), "w") as f:
            f.write("".join(r.to_text() for r in bsmr))
        with open(os.path.join(log_dir, f"gather_dot_{name}.log"),
                  "w") as f:
            f.write(RunLog(backend="gather_dot", sddmm_ms=1.1,
                           check_result="pass", **common).to_text())
        if i == 0:
            with open(os.path.join(log_dir, f"bcoo_{name}.log"), "w") as f:
                f.write(RunLog(backend="bcoo", sddmm_ms=0.9,
                               check_result="pass", **common).to_text())
        with open(os.path.join(log_dir + "_fp16", f"BSMR_{name}.log"),
                  "w") as f:
            f.write(RunLog(alpha=0.1, delta=0.002, sddmm_ms=0.15,
                           check_result="pass", **common).to_text())


def test_replica_summarize_matches_analyze_replicas(tmp_path, monkeypatch,
                                                   capsys):
    """summarize() and scripts/analyze_replicas.py write the same
    results_128.csv (round 5's columns) and summary_128.json from the same
    logs."""
    logs = str(tmp_path / "logs")
    _replica_logs(logs)
    got = replica_suite.summarize(logs, str(tmp_path / "torch"),
                                  echo=lambda *_: None)
    spec = importlib.util.spec_from_file_location(
        "analyze_replicas", os.path.join(REPO, "scripts",
                                         "analyze_replicas.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr("sys.argv", ["analyze_replicas.py", logs,
                                     str(tmp_path / "jax"), "128"])
    assert script.main() == 0
    capsys.readouterr()
    for name in ("results_128.csv", "summary_128.json"):
        with open(tmp_path / "torch" / name) as a, \
                open(tmp_path / "jax" / name) as b:
            assert a.read() == b.read()
    assert got["bsmr_accuracy"] == 1.0 and got["n_matrices"] == 3
    with open(tmp_path / "torch" / "results_128.csv") as f:
        header = f.readline().strip().split(",")
    with open(os.path.join(REPO, "results", "v5e_r5",
                           "results_128.csv")) as f:
        assert header == f.readline().strip().split(",")


def test_replica_suite_end_to_end_cpu(tmp_path, monkeypatch, capsys):
    """The in-process sweep on the CPU (--device cpu) over the three
    smallest replicas, one per regime: every matrix logged with its
    validated arms passing and gather_dot/bcoo beside it, the summary
    written to --out-dir with accuracy 1.0; a rerun skips every logged
    matrix and summarizes the same logs."""
    args = ["--count", "1", "--max-nnz", "105000", "-k", "32",
            "--alphas", "0.3", "--configs", "0.002:0", "0.02:12",
            "--dataset-dir", str(tmp_path / "data"),
            "--log-dir", str(tmp_path / "logs"),
            "--out-dir", str(tmp_path / "out"),
            "--stop-file", str(tmp_path / "stop"), "--device", "cpu"]
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path / "cache"))
    assert replica_suite.main(args) == 0
    first = capsys.readouterr().out
    assert "done; 0 failures" in first
    logs = sorted(os.listdir(tmp_path / "logs"))
    names = ("psse0", "skirt", "vsp_barth5_1Ksep_50in_5Kout")
    assert [f"BSMR_{n}.log" for n in names] == [
        f for f in logs if f.startswith("BSMR_")]
    assert [f"gather_dot_{n}.log" for n in names] == [
        f for f in logs if f.startswith("gather_dot_")]
    assert {f for f in logs if f.startswith("bcoo_")} == {
        "bcoo_psse0.log", "bcoo_skirt.log"}   # N <= --bcoo-max-n
    with open(tmp_path / "out" / "summary_32.json") as f:
        summary = json.load(f)
    assert summary["n_matrices"] == 3 and summary["bsmr_accuracy"] == 1.0
    # 3 matrices x 2 subpack arms, each validated
    assert len(re.findall(r"^\[\d/3 .* check=pass ", first, re.M)) == 6
    assert replica_suite.main(args) == 0
    again = capsys.readouterr().out
    assert again.count("skip (log exists)") == 3
    with open(tmp_path / "out" / "summary_32.json") as f:
        assert json.load(f) == summary
