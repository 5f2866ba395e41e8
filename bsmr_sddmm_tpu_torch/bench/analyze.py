"""Log analyzer: best-config-per-matrix, speedups, accuracy, CSV output.

A copy of ``bsmr_sddmm_tpu.bench.analyze`` on this package's ``logger`` and
``baselines``: the same log files give the same CSVs, byte for byte. Python
port of the reference's scripts/analyze_results.cpp (1,386 LoC):

* parse ``[key : value]`` records separated by ``---New data---`` lines
  (analyze_results.cpp:16-120),
* keep the best-GFLOPS configuration per (matrix, K) for BSMR and each
  baseline (analyze_results.cpp:243-247, 316-331),
* compute per-baseline speedup distributions and geomeans
  (analyze_results.cpp:539-566, 604-628),
* accuracy accounting from ``checkResults`` lines
  (analyze_results.cpp:498-536),
* dataset statistics and alpha/delta mode analysis
  (analyze_results.cpp:1205-1324),
* write ``results_{K}.csv`` and ``results_hybrid_{K}.csv``
  (analyze_results.cpp:789, 1127).
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import math
import os
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

from bsmr_sddmm_tpu_torch.utils.logger import parse_log_text


@dataclasses.dataclass
class MatrixResult:
    """Best-configuration record for one (matrix, K, method)."""

    file: str
    method: str          # "bsmr" or a baseline name
    k: int = 0
    m: int = 0
    n: int = 0
    nnz: int = 0
    sparsity: float = 0.0
    alpha: float = float("nan")
    delta: float = float("nan")
    gflops: float = 0.0
    sddmm_ms: float = 0.0
    check_result: str = "untested"
    num_dense_blocks: int = 0
    dense_nnz: int = 0
    residual_nnz: int = 0
    packed_nnz: int = 0
    average_tile_density: float = 0.0
    row_reordering_ms: float = 0.0
    col_reordering_ms: float = 0.0
    pack_ms: float = 0.0
    # measured per-tier split (benchmark(tier_times=True); the analogue
    # of the reference's overlap-efficiency line, sddmmKernel.cu:2834-2844)
    tier_dense_ms: float = 0.0
    tier_gathered_ms: float = 0.0
    tier_residual_ms: float = 0.0
    tier_overlap_efficiency: float = 0.0


def _f(rec: Dict[str, str], key: str, default: float = 0.0) -> float:
    try:
        return float(rec.get(key, default))
    except ValueError:
        return default


def _i(rec: Dict[str, str], key: str, default: int = 0) -> int:
    try:
        return int(float(rec.get(key, default)))
    except ValueError:
        return default


def record_to_result(rec: Dict[str, str]) -> Optional[MatrixResult]:
    """One parsed [key : value] record -> MatrixResult, or None if it is
    not a benchmark record."""
    if "File" not in rec:
        return None
    backend = rec.get("backend", "")
    method = backend if backend in _BASELINE_KEYS else "bsmr"
    gflops = _f(rec, "bsmr_gflops") or _f(rec, "gflops")
    ms = _f(rec, "bsmr_sddmm") or _f(rec, "sddmm_ms")
    if gflops == 0.0 and ms > 0:
        gflops = 2.0 * _i(rec, "NNZ") * _i(rec, "K") / (ms * 1e6)
    return MatrixResult(
        file=rec["File"], method=method,
        k=_i(rec, "K"), m=_i(rec, "M"), n=_i(rec, "N"),
        nnz=_i(rec, "NNZ"), sparsity=_f(rec, "sparsity"),
        alpha=_f(rec, "alpha", float("nan")),
        delta=_f(rec, "delta", float("nan")),
        gflops=gflops, sddmm_ms=ms,
        check_result=rec.get("checkResults", "untested"),
        num_dense_blocks=_i(rec, "numDenseBlocks"),
        dense_nnz=_i(rec, "denseNNZ"),
        residual_nnz=_i(rec, "residualNNZ"),
        packed_nnz=_i(rec, "packedNNZ"),
        average_tile_density=_f(rec, "averageDensity"),
        row_reordering_ms=_f(rec, "bsmr_rowReordering"),
        col_reordering_ms=_f(rec, "bsmr_colReordering"),
        pack_ms=_f(rec, "rphm"),
        tier_dense_ms=_f(rec, "tier_dense_ms"),
        tier_gathered_ms=_f(rec, "tier_gathered_ms"),
        tier_residual_ms=_f(rec, "tier_residual_ms"),
        tier_overlap_efficiency=_f(rec, "tier_overlap_efficiency"),
    )


def _baseline_keys() -> set:
    """Baseline method names, data-driven from the baselines registry so
    adding a baseline never misclassifies its records as "bsmr"."""
    from bsmr_sddmm_tpu_torch.baselines import _FACTORIES
    return set(_FACTORIES)


_BASELINE_KEYS = _baseline_keys()


def parse_log_files(paths: Iterable[str]) -> List[MatrixResult]:
    results = []
    for path in paths:
        with open(path) as f:
            text = f.read()
        for rec in parse_log_text(text):
            r = record_to_result(rec)
            if r is not None:
                results.append(r)
    return results


def best_per_matrix(results: Sequence[MatrixResult]
                    ) -> Dict[tuple, MatrixResult]:
    """Keep the best-GFLOPS record per (file, K, method) — the reference's
    best-over-the-sweep methodology (analyze_results.cpp:316-331). Re-runs
    of the same config dedup to the best, which makes a killed-and-rerun
    sweep mergeable (SURVEY.md section 5, checkpoint/resume)."""
    best: Dict[tuple, MatrixResult] = {}
    for r in results:
        key = (r.file, r.k, r.method)
        if key not in best or r.gflops > best[key].gflops:
            best[key] = r
    return best


@dataclasses.dataclass
class Analysis:
    k: int
    rows: List[Dict]                      # one per matrix
    geomean: Dict[str, float]             # method -> geomean GFLOPS
    speedup_geomean: Dict[str, float]     # baseline -> geomean(bsmr/base)
    accuracy: Dict[str, float]            # method -> pass rate
    mode_alpha: Optional[float] = None    # most frequent best alpha
    mode_delta: Optional[float] = None


def _geomean(vals: Sequence[float]) -> float:
    vals = [v for v in vals if v > 0]
    if not vals:
        return 0.0
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def analyze_logs(paths: Iterable[str], k: int) -> Analysis:
    """Full analysis for one K (the reference emits one CSV per K)."""
    best = best_per_matrix(parse_log_files(paths))
    files = sorted({f for (f, kk, _m) in best if kk == k})
    methods = sorted({m for (_f2, kk, m) in best if kk == k})
    rows = []
    per_method: Dict[str, List[float]] = defaultdict(list)
    speedups: Dict[str, List[float]] = defaultdict(list)
    checks: Dict[str, List[bool]] = defaultdict(list)
    alphas, deltas = Counter(), Counter()
    for fname in files:
        row: Dict[str, object] = {"file": fname}
        bsmr = best.get((fname, k, "bsmr"))
        if bsmr:
            row.update(M=bsmr.m, N=bsmr.n, NNZ=bsmr.nnz,
                       sparsity=round(bsmr.sparsity, 6),
                       alpha=bsmr.alpha, delta=bsmr.delta,
                       bsmr=round(bsmr.gflops, 3))
            if bsmr.tier_overlap_efficiency:
                row.update(
                    tier_dense_ms=bsmr.tier_dense_ms,
                    tier_gathered_ms=bsmr.tier_gathered_ms,
                    tier_residual_ms=bsmr.tier_residual_ms,
                    tier_overlap_efficiency=bsmr.tier_overlap_efficiency)
            per_method["bsmr"].append(bsmr.gflops)
            if bsmr.check_result != "untested":
                checks["bsmr"].append(bsmr.check_result == "pass")
            if not math.isnan(bsmr.alpha):
                alphas[bsmr.alpha] += 1
            if not math.isnan(bsmr.delta):
                deltas[bsmr.delta] += 1
        for m in methods:
            if m == "bsmr":
                continue
            r = best.get((fname, k, m))
            if r:
                row[m] = round(r.gflops, 3)
                per_method[m].append(r.gflops)
                if r.check_result != "untested":
                    checks[m].append(r.check_result == "pass")
                if bsmr and r.gflops > 0:
                    speedups[m].append(bsmr.gflops / r.gflops)
        rows.append(row)
    return Analysis(
        k=k,
        rows=rows,
        geomean={m: _geomean(v) for m, v in per_method.items()},
        speedup_geomean={m: _geomean(v) for m, v in speedups.items()},
        accuracy={m: (sum(v) / len(v) if v else 1.0)
                  for m, v in checks.items()},
        mode_alpha=alphas.most_common(1)[0][0] if alphas else None,
        mode_delta=deltas.most_common(1)[0][0] if deltas else None,
    )


def write_results_csv(analysis: Analysis, out_dir: str) -> str:
    """Write ``results_{K}.csv`` (analyze_results.cpp:789 format: one row
    per matrix, one column per method's best GFLOPS)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"results_{analysis.k}.csv")
    cols: List[str] = []
    for row in analysis.rows:
        for key in row:
            if key not in cols:
                cols.append(key)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        for row in analysis.rows:
            w.writerow(row)
    return path


def write_hybrid_csv(paths: Iterable[str], k: int, out_dir: str) -> str:
    """``results_hybrid_{K}.csv`` (analyze_results.cpp:1127): per matrix,
    best hybrid GFLOPS vs the dense-only (delta=0) and residual-only
    (delta >= 1) ablations from the same sweep logs."""
    best_any: Dict[str, MatrixResult] = {}
    best_dense: Dict[str, MatrixResult] = {}
    best_resid: Dict[str, MatrixResult] = {}
    for r in parse_log_files(paths):
        if r.method != "bsmr" or r.k != k:
            continue
        def upd(d):
            if r.file not in d or r.gflops > d[r.file].gflops:
                d[r.file] = r
        upd(best_any)
        if r.delta == 0.0:
            upd(best_dense)
        elif r.delta > 1.0:
            upd(best_resid)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"results_hybrid_{k}.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file", "NNZ", "hybrid", "dense_only", "residual_only"])
        for fname in sorted(best_any):
            r = best_any[fname]
            d = best_dense.get(fname)
            s = best_resid.get(fname)
            w.writerow([fname, r.nnz, round(r.gflops, 3),
                        round(d.gflops, 3) if d else "",
                        round(s.gflops, 3) if s else ""])
    return path


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="bsmr-analyze-torch",
        description="Analyze [key : value] benchmark logs "
                    "(reference analyze_results.cpp)")
    p.add_argument("logs", nargs="+", help="log files or globs")
    p.add_argument("-k", type=int, action="append", default=None,
                   help="K values to analyze (default: all found)")
    p.add_argument("-o", "--out-dir",
                   default=os.path.join("build", "results"))
    p.add_argument("--hybrid", action="store_true",
                   help="also write results_hybrid_{K}.csv")
    args = p.parse_args(argv)
    paths = []
    for pat in args.logs:
        paths.extend(sorted(glob.glob(pat)) or [pat])
    ks = args.k
    if not ks:
        ks = sorted({r.k for r in parse_log_files(paths)})
    for k in ks:
        a = analyze_logs(paths, k)
        csv_path = write_results_csv(a, args.out_dir)
        print(f"K={k}: {len(a.rows)} matrices -> {csv_path}")
        for m, g in sorted(a.geomean.items()):
            extra = ""
            if m in a.speedup_geomean:
                extra = f"  (bsmr speedup geomean "\
                        f"{a.speedup_geomean[m]:.2f}x)"
            print(f"  {m:>14}: geomean {g:8.1f} GFLOPS, "
                  f"accuracy {a.accuracy.get(m, 1.0):6.2%}{extra}")
        if a.mode_alpha is not None:
            print(f"  best-config modes: alpha={a.mode_alpha} "
                  f"delta={a.mode_delta}")
        if args.hybrid:
            print(f"  hybrid ablation -> "
                  f"{write_hybrid_csv(paths, k, args.out_dir)}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
