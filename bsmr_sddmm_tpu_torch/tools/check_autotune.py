"""Autotune against the sweep best: the port of ``scripts/check_autotune.py``.

    python -m bsmr_sddmm_tpu_torch.tools.check_autotune SWEEP_LOG \
        [--ks 32 128] [--alpha 0.3] [--auto-alpha] [--costs v5e|current] \
        [--out FILE] [--device cpu]
    python -m bsmr_sddmm_tpu_torch.tools.check_autotune --arms ARMS_JSON \
        [--time-outside-grid] [...]

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
positions after it, and the rule then misreads the group. Two port-only
additions repair what the JAX script gets wrong, and leave ``parse_lines``,
``parse_log`` and ``check`` at their defaults equal to it:

* ``runs_from_records`` (``--arms FILE``) builds the same dict from the
  records ``bench.suite`` writes with ``--arms`` (``run(records=...)``),
  which name each arm's subpack: every arm is attributed right;
* ``check(..., time_outside_grid=device)`` (``--time-outside-grid``) times
  a pick the sweep lacks (``delta 0.006`` at subpack 12, say) on the device
  with ``BsmrSddmm.benchmark``, as ``probe_refine_pick.probe_cell`` does,
  where the JAX script leaves its fraction None; such a row says
  ``"timed_outside_grid": true``.

Host-only without ``time_outside_grid``: packing and pricing, no device
work. The price table is ``V5E_COSTS`` (``--costs current``:
``autotune.current_costs()``).
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


def runs_from_records(records) -> dict:
    """``parse_lines``' dict from ``bench.suite``'s arm records: {(name,
    k): {(alpha, delta, sub): gflops}} over the fp32 arms, each under the
    subpack it ran with. An arm whose check failed is left out: a wrong
    result is no candidate for the best."""
    runs = collections.defaultdict(dict)
    for r in records:
        if r["dtype"] == "float32" and r["check"] != "fail":
            runs[(r["matrix"], int(r["k"]))][
                (float(r["alpha"]), float(r["delta"]),
                 int(r["subpack"]))] = float(r["gflops"])
    return runs


def time_arm(csr, name: str, k: int, arm, device) -> float:
    """GFLOPS of one (alpha, delta, subpack) arm on ``device``, timed by
    ``BsmrSddmm.benchmark`` on ``bench.suite``'s config and operands."""
    import numpy as np
    import torch

    from bsmr_sddmm_tpu_torch.config import SddmmConfig
    from bsmr_sddmm_tpu_torch.formats import make_dense
    from bsmr_sddmm_tpu_torch.sddmm import BsmrSddmm

    alpha, delta, sub = arm
    device = resolve_device(device)
    pipe = BsmrSddmm(csr, SddmmConfig(
        k=128, panel_height=32, num_iterations=10, reorder_cache=True,
        subpack_min_nnz=sub), device=device)
    A = torch.from_numpy(make_dense(csr.rows, k, seed=1337)).to(device)
    Bt = torch.from_numpy(np.ascontiguousarray(
        make_dense(k, csr.cols, seed=1338).T)).to(device)
    log = pipe.benchmark(A, Bt, alpha=alpha, delta=delta,
                         time_csr_emit=False, file=name)
    return float(log.gflops)


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
          echo: Callable[[str], None] = print,
          time_outside_grid=None) -> dict:
    """The picks against the sweep best for every (name, K) of ``runs``
    whose matrix is in ``suite`` ((name, generator) pairs): ``{
    "mean_fraction", "min_fraction", "rows"}``. ``costs`` prices the picks
    (default: the table in effect). ``time_outside_grid``, a device, times
    each pick the sweep lacks there (``time_arm``) and marks its row
    ``"timed_outside_grid": true``; None (the default, the JAX script's
    behaviour) leaves that row's fraction None."""
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
                timed = got is None and time_outside_grid is not None
                if timed:
                    arm = picked if auto_alpha else (alpha,) + picked
                    got = time_arm(csr, name, k, arm, time_outside_grid)
                rows.append({"matrix": name, "k": k,
                             "picked": list(picked),
                             "picked_gflops": got,
                             "best": list(best_cfg),
                             "best_gflops": cands[best_cfg],
                             "fraction": (round(got / cands[best_cfg], 3)
                                          if got else None)})
                if timed:
                    rows[-1]["timed_outside_grid"] = True
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
    p.add_argument("log", nargs="?", default=None,
                   help="bench.suite stderr log with sweep lines")
    p.add_argument("--arms", default=None, metavar="FILE",
                   help="bench.suite --arms records, read in place of the "
                        "log (each arm under the subpack it ran with)")
    p.add_argument("--time-outside-grid", action="store_true",
                   help="time a pick the sweep lacks on the device, so "
                        "that its row gets a fraction")
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
    device = resolve_device(args.device)
    if (args.log is None) == (args.arms is None):
        p.error("give one of a sweep log and --arms FILE")
    from bsmr_sddmm_tpu_torch.datasets import SUITE
    from bsmr_sddmm_tpu_torch.utils.hostmem import tune_malloc
    tune_malloc()   # packing is allocation-bound on a small host

    if args.arms:
        with open(args.arms) as f:
            runs = runs_from_records(json.load(f))
    else:
        runs = parse_log(args.log)
    summary = check(runs, SUITE, ks=args.ks,
                    alpha=args.alpha, auto_alpha=args.auto_alpha,
                    costs=costs_of(args),
                    echo=lambda m: print(m, flush=True),
                    time_outside_grid=(device if args.time_outside_grid
                                       else None))
    print(json.dumps({k: summary[k] for k in
                      ("mean_fraction", "min_fraction")}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
