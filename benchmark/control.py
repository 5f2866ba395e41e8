"""Readings for the limits of ``correct``: the compared number
(``max_rel_err``) of the program and of its control on many seeds, in one
process per cell.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 1]

The control is the program with its own lower-precision path switched on:
``matmul_precision="default"``, one TF32 pass in every hand kernel and TF32
in the torch tiers, the nearest precision below the configuration's (three
TF32 passes, TF32 off elsewhere). Each seed gets its own operand ring, its
callers and warm-up, a window of ``--seconds`` at the cell's own load and
the check of every pair's last output. The benchmark's own runs do not run
this. Prints one JSON line: the readings by seed, and the largest of the
program's and the smallest of the control's.
"""

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def readings(cell_name, seeds, seconds, settings=None):
    """``{seed: max_rel_err}`` of the cell's program (with ``settings``)."""
    import torch
    from benchmark import loadgen, spec
    bench = spec.load_benchmark()
    cell = spec.cell(bench, cell_name)
    c = loadgen.Cell(spec.config(bench, cell["config"]),
                     spec.traffic(cell["traffic"]), torch.device("cuda", 0),
                     settings)
    run = c.prepare(os.path.join(spec.ROOT, "build"))
    out = {}
    for seed in seeds:
        c.load(run, seed)
        c.window(run, seconds)
        c.check(run, keep_body=True)
        out[seed] = run.max_rel_err
        print(f"{cell_name} {settings or 'program'} seed {seed}: "
              f"max_rel_err {run.max_rel_err!r}, {run.calls} calls",
              file=sys.stderr, flush=True)
    return out


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    control_seeds = [int(s) for s in args.control_seeds.split(",")]
    t0 = time.perf_counter()
    program = readings(args.workload, seeds, args.seconds)
    control = readings(args.workload, control_seeds, args.seconds,
                       {"matmul_precision": "default"})
    print(json.dumps({"workload": args.workload,
                      "device": torch.cuda.get_device_name(0),
                      "program": program, "control": control,
                      "lower": max(program.values()),
                      "upper": min(control.values()),
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
