"""Autotune pick quality with and without measured refinement: the port of
``scripts/probe_refine_pick.py``.

    python -m bsmr_sddmm_tpu_torch.tools.probe_refine_pick \
        [--out build/arm_audit/refine_pick.json] [--iterations 10] \
        [--device cpu]

For each probed (matrix, K): time the full (alpha x delta x subpack) grid
on the device (the measured best), then the
  host pick     = choose_config(refine_top=0), the cost model alone, and the
  refined pick  = choose_config(refine_top=3), its top 3 re-timed,
each as a fraction of the swept best. A pick outside the grid is timed too.
Every time is ``BsmrSddmm.benchmark``'s (a replayed CUDA graph on the
card), as ``autotune._refine_measure`` times its candidates. The pricing
table is the one in effect (``autotune.current_costs()``). An arm that
fails raises, where the JAX script prints it and sweeps on: a kernel fault
must not hide as a missing arm.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable

import numpy as np

from bsmr_sddmm_tpu_torch.ops.sddmm import resolve_device
from bsmr_sddmm_tpu_torch.tools import add_device_arg

CELLS = [
    ("banded_mesh_32k", 32),    # the round-3/4 fusion-pathology cell
    ("banded_mesh_64k", 256),   # tier_serialize home turf
    ("community_20k", 128),     # packed-tier undervaluation cell
    ("rmat_16", 128),
]
ALPHAS = (0.1, 0.3, 0.5)
DELTAS = (0.002, 0.006, 0.02)
SUBS = (0, 12)


def probe_cell(name: str, csr, K: int, device, iterations: int = 10,
               echo: Callable[[str], None] = print) -> dict:
    """Sweep ALPHAS x DELTAS x SUBS on ``csr`` at ``K`` and place the host
    and the refined picks against the best: ``{matrix, k, sweep_best:
    [arm, ms], host_pick: [arm, ms, fraction], refined_pick: [...]}``."""
    import torch

    from bsmr_sddmm_tpu_torch.autotune import choose_config
    from bsmr_sddmm_tpu_torch.config import SddmmConfig
    from bsmr_sddmm_tpu_torch.formats import make_dense
    from bsmr_sddmm_tpu_torch.sddmm import BsmrSddmm

    cfg = SddmmConfig(k=K, panel_height=32, reorder_cache=True,
                      num_iterations=iterations, subpack_min_nnz=12)
    pipes = {s: BsmrSddmm(csr, cfg.replace(subpack_min_nnz=s),
                          device=device) for s in SUBS}
    p0 = next(iter(pipes.values()))
    for pp in pipes.values():
        pp._row_cache = p0._row_cache
    A = torch.from_numpy(make_dense(csr.rows, K, seed=1337)).to(device)
    B = torch.from_numpy(np.ascontiguousarray(
        make_dense(K, csr.cols, seed=1338).T)).to(device)
    sweep = {}
    for alpha in ALPHAS:
        for delta in DELTAS:
            for sub in SUBS:
                log = pipes[sub].benchmark(A, B, alpha=alpha, delta=delta,
                                           time_csr_emit=False, file=name)
                sweep[(alpha, delta, sub)] = log.sddmm_ms
                echo(f"# {name} k={K} a={alpha} d={delta} s={sub}: "
                     f"{log.sddmm_ms:.3f} ms")
    best_key = min(sweep, key=sweep.get)
    best_ms = sweep[best_key]

    def pick_ms(refine):
        choice = choose_config(csr, p0._row_reordering, cfg,
                               alphas=ALPHAS, candidates=DELTAS,
                               k=K, allow_dense=False,
                               refine_top=refine, device=device)
        key = (choice.alpha, choice.delta, choice.subpack)
        if key not in sweep:   # pick outside the swept grid: time it
            log = pipes[choice.subpack].benchmark(
                A, B, alpha=choice.alpha, delta=choice.delta,
                time_csr_emit=False, file=name)
            sweep[key] = log.sddmm_ms
        return key, sweep[key]

    host_key, host_ms = pick_ms(0)
    ref_key, ref_ms = pick_ms(3)
    return dict(matrix=name, k=K,
                sweep_best=[list(best_key), round(best_ms, 4)],
                host_pick=[list(host_key), round(host_ms, 4),
                           round(best_ms / host_ms, 3)],
                refined_pick=[list(ref_key), round(ref_ms, 4),
                              round(best_ms / ref_ms, 3)])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="host and refined autotune picks against the swept "
                    "best")
    p.add_argument("--out", default=os.path.join("build", "arm_audit",
                                                 "refine_pick.json"))
    p.add_argument("--iterations", type=int, default=10)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    from bsmr_sddmm_tpu_torch.datasets import SUITE
    from bsmr_sddmm_tpu_torch.utils.hostmem import tune_malloc
    tune_malloc()

    gens = dict(SUITE)
    out = []
    for name, K in CELLS:
        row = probe_cell(name, gens[name](), K, device, args.iterations,
                         echo=lambda m: print(m, file=sys.stderr,
                                              flush=True))
        out.append(row)
        print("#", json.dumps(row), file=sys.stderr, flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    fr_host = [r["host_pick"][2] for r in out]
    fr_ref = [r["refined_pick"][2] for r in out]
    print(json.dumps({
        "host_fraction_min": min(fr_host), "host_fraction_mean":
            round(float(np.mean(fr_host)), 3),
        "refined_fraction_min": min(fr_ref), "refined_fraction_mean":
            round(float(np.mean(fr_ref)), 3),
        "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
