"""One run of one cell: ``python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.

Set-up (timed as ``setup_s`` from the start of the process): the mask, the
preprocessings (``prep_s``), the body, the operand ring from ``--seed``,
the captures and the warm-up calls. Then back-to-back calls for
``--seconds``; traced, after them, ``trace_calls`` calls under the
profiler. Then the check: every pair's last output against the plain
reference. The last line of standard
output is the result's JSON object; the last lines of standard error give
each number compared beside its limit.

A run needs a CUDA card (the cell's ``chips`` of them) and exits with 2,
printing no result, where there is none; it exits with 3 if the JAX package
or JAX was loaded into the process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

#: top-level modules that may not be loaded into a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "bsmr_sddmm_tpu")


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(names=None) -> List[str]:
    """The top-level names among ``names`` (default: the loaded modules)
    that are one of FORBIDDEN, each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device, t_start: float, root: Optional[str] = None,
            settings: Optional[dict] = None):
    """Set up and run the cell; returns ``(run, bench, cell, config)``."""
    from benchmark import loadgen, spec
    root = root or spec.ROOT
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, cell_name)
    config = spec.config(bench, cell["config"], root)
    traffic = spec.traffic(cell["traffic"], root)
    c = loadgen.Cell(config, traffic, device, settings, root)
    t_prepare = time.perf_counter()
    run = c.prepare(os.path.join(root, "build"))
    run.setup_parts = {"start": t_prepare - t_start, **run.setup_parts}
    c.load(run, seed)
    run.setup_s = time.perf_counter() - t_start
    c.window(run, seconds)
    if trace:
        c.trace(run, int(traffic["trace_calls"]))
    c.counters(run)
    c.check(run)
    return run, bench, cell, config


def result(run, bench: dict, cell: dict, config: dict, trace: bool,
           device_count: int, root: Optional[str] = None) -> dict:
    """The result object of a finished run."""
    from benchmark import spec
    root = root or spec.ROOT
    metrics = {}
    for entry in spec.metrics_of(bench, cell["name"], trace):
        value = spec.metric(entry["name"], root).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    limit = config["check"]["max_rel_err"]
    failed = sum(err > limit for err in run.pair_errs)
    device = {"platform": "gpu" if run.device_name != "cpu" else "cpu",
              "kind": run.device_name, "count": device_count,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": bool(run.pair_errs) and failed == 0,
           "attempted": run.attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if trace and run.traced is not None:
        device["busy_s"] = run.traced["busy_s"]
        device["window_s"] = run.traced["window_s"]
        out["breakdown"] = {"device_ops": run.traced["device_ops"],
                            "idle_gaps": run.traced["idle_gaps"]}
    out["checks"] = {"max_rel_err": {"value": run.max_rel_err,
                                     "limit": limit},
                     "pairs_failed": {"value": failed, "limit": 0}}
    return out


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    from benchmark import spec
    bench = spec.load_benchmark()
    chips = int(spec.cell(bench, args.workload)["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"no CUDA card, or fewer than the {chips} this cell needs "
            f"(found {torch.cuda.device_count()}): no result")
        return 2
    run, bench, cell, config = execute(
        args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), t_start)
    out = result(run, bench, cell, config, bool(args.trace), chips)
    found = forbidden_modules()
    if found:
        say(f"the run loaded {', '.join(found)}: no result")
        return 3
    say(f"card: {_power_limit()}")
    say(f"counters: {json.dumps(run.counters)}")
    say(f"setup_s {run.setup_s:.3f}, of which seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup_parts.items()))
    say("prep_s of each preprocessing: "
        + ", ".join(f"{s:.4f}" for s in run.prep_s))
    if run.traced is not None:
        t = run.traced
        say(f"traced: {t['calls']} calls in {t['window_s']:.6f} s, busy "
            f"{t['busy_s']:.6f} s, traced sddmm_gflops "
            f"{2 * run.nnz * run.k * t['calls'] / t['window_s'] / 1e9:.3f}")
    say(f"pairs: {run.pairs}, per-pair max_rel_err: "
        f"{[float(f'{e:.4g}') for e in run.pair_errs]}")
    print(json.dumps(out), flush=True)
    for name, check in out["checks"].items():
        say(f"check {name} {check['value']!r} limit {check['limit']!r}")
    return 0
