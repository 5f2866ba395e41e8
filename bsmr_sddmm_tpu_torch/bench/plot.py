"""Figure plotters, porting the reference's paper-figure scripts.

A copy of ``bsmr_sddmm_tpu.bench.plot``. matplotlib is imported only inside
each plotter, so the rest of the package runs on a host without it; the
figures are drawn wherever matplotlib is installed, from the CSVs and logs
a GPU run wrote.

* ``plot_sddmm``      — GFLOPS vs NNZ per method, rolling-window smoothing
                        (reference scripts/plot_sddmm.py:24-139: window 5,
                        default NNZ filter 1e5..2e6).
* ``plot_hybrid``     — hybrid vs dense-only vs residual-only ablation
                        (reference scripts/plot_hybrid.py).
* ``plot_reordering`` — reordering overhead vs kernel-time payoff
                        (reference scripts/plot_reordering_overhead.py:14-50).

matplotlib only; no seaborn dependency.
"""

from __future__ import annotations

import csv
import math
from typing import List, Optional, Sequence


def _rolling_geomean(xs: List[float], ys: List[float], window: int = 5):
    """Sort by x and geometric-mean y over a centered rolling window
    (plot_sddmm.py uses a rolling window of 5 over NNZ-sorted points)."""
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    xs = [xs[i] for i in order]
    ys = [ys[i] for i in order]
    out_x, out_y = [], []
    h = window // 2
    for i in range(len(xs)):
        lo, hi = max(0, i - h), min(len(xs), i + h + 1)
        vals = [y for y in ys[lo:hi] if y > 0]
        if vals:
            out_x.append(xs[i])
            out_y.append(math.exp(sum(math.log(v) for v in vals)
                                  / len(vals)))
    return out_x, out_y


def _read_csv(path: str) -> List[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def plot_sddmm(results_csv: str, out_png: str, window: int = 5,
               nnz_min: float = 0.0, nnz_max: float = float("inf"),
               methods: Optional[Sequence[str]] = None) -> str:
    """GFLOPS-vs-NNZ comparison figure from a results_{K}.csv."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _read_csv(results_csv)
    meta = {"file", "M", "N", "NNZ", "sparsity", "alpha", "delta"}
    if methods is None:
        methods = [c for c in rows[0] if c not in meta]
    fig, ax = plt.subplots(figsize=(8, 4.5))
    for m in methods:
        xs, ys = [], []
        for r in rows:
            try:
                nnz = float(r["NNZ"])
                g = float(r.get(m) or 0)
            except (KeyError, ValueError):
                continue
            if g > 0 and nnz_min <= nnz <= nnz_max:
                xs.append(nnz)
                ys.append(g)
        if xs:
            rx, ry = _rolling_geomean(xs, ys, window)
            ax.plot(rx, ry, label=m, linewidth=1.6)
    ax.set_xscale("log")
    ax.set_xlabel("NNZ")
    ax.set_ylabel("GFLOPS (rolling geomean)")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_hybrid(hybrid_csv: str, out_png: str, window: int = 5) -> str:
    """Hybrid vs dense-only vs residual-only ablation figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _read_csv(hybrid_csv)
    fig, ax = plt.subplots(figsize=(8, 4.5))
    for col, label in (("hybrid", "hybrid"),
                       ("dense_only", "dense tiles only (delta=0)"),
                       ("residual_only", "residual only (delta>1)")):
        xs, ys = [], []
        for r in rows:
            try:
                nnz = float(r["NNZ"])
                g = float(r.get(col) or 0)
            except (KeyError, ValueError):
                continue
            if g > 0:
                xs.append(nnz)
                ys.append(g)
        if xs:
            rx, ry = _rolling_geomean(xs, ys, window)
            ax.plot(rx, ry, label=label, linewidth=1.6)
    ax.set_xscale("log")
    ax.set_xlabel("NNZ")
    ax.set_ylabel("GFLOPS (rolling geomean)")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_reordering_overhead(log_paths: Sequence[str], out_png: str,
                             k: int = 128) -> str:
    """Preprocessing overhead vs amortization: reorder+pack time against
    the per-iteration kernel-time saving, per matrix (reference
    plot_reordering_overhead.py shows reordering cost distributions)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from bsmr_sddmm_tpu_torch.bench.analyze import best_per_matrix, \
        parse_log_files

    best = best_per_matrix(parse_log_files(log_paths))
    xs, pre_ms, kern_ms = [], [], []
    for (fname, kk, method), r in sorted(best.items()):
        if method != "bsmr" or kk != k:
            continue
        xs.append(r.nnz)
        pre_ms.append(r.row_reordering_ms + r.col_reordering_ms + r.pack_ms)
        kern_ms.append(r.sddmm_ms)
    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.scatter(xs, pre_ms, s=14, label="preprocess (reorder+pack) ms")
    ax.scatter(xs, kern_ms, s=14, label="sddmm kernel ms")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("NNZ")
    ax.set_ylabel("milliseconds")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="bsmr-plot-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("sddmm")
    ps.add_argument("results_csv")
    ps.add_argument("-o", "--out", default="sddmm.png")
    ps.add_argument("--window", type=int, default=5)
    ps.add_argument("--nnz-min", type=float, default=0.0)
    ps.add_argument("--nnz-max", type=float, default=float("inf"))
    ph = sub.add_parser("hybrid")
    ph.add_argument("hybrid_csv")
    ph.add_argument("-o", "--out", default="hybrid.png")
    pr = sub.add_parser("reordering")
    pr.add_argument("logs", nargs="+")
    pr.add_argument("-o", "--out", default="reordering.png")
    pr.add_argument("-k", type=int, default=128)
    args = p.parse_args(argv)
    if args.cmd == "sddmm":
        out = plot_sddmm(args.results_csv, args.out, window=args.window,
                         nnz_min=args.nnz_min, nnz_max=args.nnz_max)
    elif args.cmd == "hybrid":
        out = plot_hybrid(args.hybrid_csv, args.out)
    else:
        out = plot_reordering_overhead(args.logs, args.out, k=args.k)
    print(out)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
