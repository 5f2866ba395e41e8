"""Autotune against the sweep best: the port of ``scripts/check_autotune.py``.

    python -m bsmr_sddmm_tpu_torch.tools.check_autotune SWEEP_LOG \
        [--ks 32 128] [--alpha 0.3] [--auto-alpha] [--costs v5e|current] \
        [--out FILE] [--device cpu]

For each suite matrix and K, the cost model's pick (``choose_delta`` at
``--alpha`` over the sweep's (delta, subpack) grid, or with ``--auto-alpha``
``choose_config`` with alpha in the choice set) against the MEASURED best
of a sweep log: the ``# name a=.. d=.. k=..: G GFLOPS`` lines that
``bench.suite`` echoes on stderr with ``BENCH_FULL_GRID=1``. Each row gives
the picked arm's measured GFLOPS as a fraction of the sweep best.

The subpack arm is not in the line: ``parse_log`` attributes it by
position within a (matrix, alpha, K) group, in ``BENCH_CONFIGS`` order, as
the JAX script does; fp16 lines (`` dt=f16`` between ``k=`` and ``:``) do
not match. A sweep line printed in place of an arm (``skipped (plan maps
...)``), or an arm that failed twice and printed no line, shifts the
positions after it, and the rule then misreads the group: ``chip_smoke.py``
holds the parse to the arms that ran.

Host-only: packing and pricing, no device work. The price table is
``V5E_COSTS`` (``--costs current``: ``autotune.current_costs()``).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import re
import sys
from typing import Callable, Optional, Sequence

from bsmr_sddmm_tpu_torch import autotune
from bsmr_sddmm_tpu_torch.ops.sddmm import resolve_device
from bsmr_sddmm_tpu_torch.tools import (add_costs_arg, add_device_arg,
                                        costs_of)

PAT = re.compile(r"# (\S+) a=([\d.]+) d=([\d.]+) k=(\d+): (\d+) GFLOPS")
# bench.suite CONFIGS order within one (matrix, alpha, K) group
BENCH_CONFIGS = ((0.002, 0), (0.006, 0), (0.002, 12), (0.02, 12))


def parse_lines(lines) -> dict:
    """-> {(name, k): {(alpha, delta, sub): gflops}} from sweep lines."""
    runs = collections.defaultdict(dict)
    seen = collections.Counter()
    for ln in lines:
        m = PAT.match(ln)
        if not m:
            continue
        name, a, d, k, gf = (m.group(1), float(m.group(2)),
                             float(m.group(3)), int(m.group(4)),
                             float(m.group(5)))
        idx = seen[(name, a, k)]
        seen[(name, a, k)] += 1
        _, sub = BENCH_CONFIGS[idx % len(BENCH_CONFIGS)]
        runs[(name, k)][(a, d, sub)] = gf
    return runs


def parse_log(path: str) -> dict:
    """``parse_lines`` over a log file."""
    with open(path) as f:
        return parse_lines(f)


@contextlib.contextmanager
def priced_with(costs: Optional[dict]):
    """Make ``costs`` the table ``autotune.current_costs()`` returns for
    the duration (None: leave the table in effect as it is)."""
    old = autotune._CALIBRATED
    if costs is not None:
        autotune._CALIBRATED = costs
    try:
        yield
    finally:
        autotune._CALIBRATED = old


def check(runs: dict, suite: Sequence, ks: Sequence[int] = (32, 128),
          alpha: float = 0.3, auto_alpha: bool = False,
          costs: Optional[dict] = None,
          echo: Callable[[str], None] = print) -> dict:
    """The picks against the sweep best for every (name, K) of ``runs``
    whose matrix is in ``suite`` ((name, generator) pairs): ``{
    "mean_fraction", "min_fraction", "rows"}``. ``costs`` prices the picks
    (default: the table in effect)."""
    from bsmr_sddmm_tpu_torch.config import SddmmConfig
    from bsmr_sddmm_tpu_torch.sddmm import BsmrSddmm

    names = {n for n, _ in runs}
    rows = []
    with priced_with(costs):
        for name, gen in suite:
            if name not in names:
                continue
            csr = gen()
            pipe = BsmrSddmm(csr, SddmmConfig(k=128, panel_height=32,
                                              subpack_min_nnz=12,
                                              reorder_cache=True))
            base = pipe._row_reordering(alpha)
            for k in ks:
                sweep = runs.get((name, k), {})
                if auto_alpha:
                    # alpha in the choice set: choose_config's (alpha,
                    # delta, sub) pick against the sweep best over the
                    # whole measured grid (alphas the sweep deduped away
                    # are excluded from both sides)
                    cands = dict(sweep)
                    if not cands:
                        continue
                    choice = autotune.choose_config(
                        csr, pipe._row_reordering, pipe.config,
                        alphas=sorted({a for a, _, _ in cands}),
                        candidates=sorted({d for _, d, _ in cands}),
                        k=k, allow_dense=False)
                    picked = (choice.alpha, choice.plan.delta_used,
                              12 if choice.plan.num_packed else 0)
                else:
                    # restrict to this alpha and the bench config grid
                    cands = {(d, s): g for (a, d, s), g in sweep.items()
                             if a == alpha}
                    if not cands:
                        continue
                    choice = autotune.choose_delta(
                        csr, base, pipe.config,
                        candidates=sorted({d for d, _ in cands}),
                        k=k, allow_dense=False)
                    picked = (choice.plan.delta_used,
                              12 if choice.plan.num_packed else 0)
                best_cfg = max(cands, key=cands.get)
                got = cands.get(picked)
                rows.append({"matrix": name, "k": k,
                             "picked": list(picked),
                             "picked_gflops": got,
                             "best": list(best_cfg),
                             "best_gflops": cands[best_cfg],
                             "fraction": (round(got / cands[best_cfg], 3)
                                          if got else None)})
                echo(f"{name} k={k}: picked {picked} "
                     f"-> {got} GFLOPS; sweep best {best_cfg} "
                     f"-> {cands[best_cfg]} "
                     f"({rows[-1]['fraction']})")
    fr = [r["fraction"] for r in rows if r["fraction"]]
    return {"mean_fraction": round(sum(fr) / max(len(fr), 1), 3),
            "min_fraction": min(fr, default=None), "rows": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="the cost model's pick against a bench.suite "
                    "full-grid sweep's measured best")
    p.add_argument("log", help="bench.suite stderr log with sweep lines")
    p.add_argument("--ks", type=int, nargs="*", default=[32, 128])
    p.add_argument("--alpha", type=float, default=0.3)
    p.add_argument("--auto-alpha", action="store_true",
                   help="check autotune.choose_config (alpha IN the "
                        "choice set) against the sweep best over ALL "
                        "alphas, instead of fixed-alpha choose_delta")
    p.add_argument("--out", default=None)
    add_costs_arg(p)
    add_device_arg(p)
    args = p.parse_args(argv)
    resolve_device(args.device)
    from bsmr_sddmm_tpu_torch.datasets import SUITE
    from bsmr_sddmm_tpu_torch.utils.hostmem import tune_malloc
    tune_malloc()   # packing is allocation-bound on a small host

    summary = check(parse_log(args.log), SUITE, ks=args.ks,
                    alpha=args.alpha, auto_alpha=args.auto_alpha,
                    costs=costs_of(args),
                    echo=lambda m: print(m, flush=True))
    print(json.dumps({k: summary[k] for k in
                      ("mean_fraction", "min_fraction")}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
