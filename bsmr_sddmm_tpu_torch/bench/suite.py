"""SUITE bench: hybrid BSMR-SDDMM throughput at K in {32, 64, 128, 256}.

    python -m bsmr_sddmm_tpu_torch.bench.suite [--device cpu]

The counterpart of the JAX package's ``bench.py`` (bench.py:103-301), step
for step on this package's ``BsmrSddmm``, on the card. Prints ONE JSON line
on stdout, ``bench.py``'s schema:

  {"metric": "sddmm_geomean_gflops_k128_suite8", "value": N,
   "unit": "GFLOPS", "vs_baseline": N, "per_k_geomean": {...},
   "per_k_vs_baseline": {...}, "per_k_geomean_fp32out": {...},
   "matrices_per_k": {...}[, "budget_skipped": [...]]
   [, "failed_cells": [...]]}

Headline value = the K=128 geomean over the SUITE matrices, best arm per
matrix. Baselines: the CUDA original's per-K geomeans over its SuiteSparse
suite on an RTX 4090 (``BASELINE_GEOMEAN_GFLOPS``, BASELINE.md). The suite
is ``datasets.SUITE``, eight synthetic stand-ins generated from seeds.

Sweep (bench.py's): per (matrix, K), K=128 first, the fixed arm of
``R4_BEST`` and its fp16-emission sibling where that table flags it;
``BENCH_EXTRA_ARMS=1`` adds the autotuner's priced pick where it differs;
``BENCH_FULL_GRID=1`` times ``ALPHAS`` x ``CONFIGS`` at K=128 and the best
``N_TRANSFER`` combos at the other K. ``R4_BEST`` and ``CONFIGS`` come from
the JAX package's round-4 full-grid sweep on a TPU v5e
(results/v5e_r4/bench_fullgrid.log): they are TPU picks, kept as the fixed
arms so cells stay comparable across PRs, not the card's best. A plan whose
maps exceed ``MAX_PLAN_BYTES`` is skipped with a line; a cell that raises
is retried once; a (matrix, K) with no measured arm runs the dense
fallback; a wall-clock budget (``BENCH_BUDGET_S``, default 1500 s) is
checked between cells, and the cells it skips are listed. ``BENCH_MATRICES``
(comma-separated) picks a subset. The reorder cache lives under
``BSMR_CACHE_DIR`` (default ``build/reorder_cache/``).

Operands are made by ``make_dense(..., seed=1337/1338)`` and uploaded once
per (matrix, K), B as (N, K). ``sddmm_ms`` is ``BsmrSddmm.benchmark``'s
replayed CUDA graph of one call. ``tune_malloc()`` runs first, then
``utils.compilecache.enable_compile_cache()`` (the nvcc build cache under
``build/torch_kernels/``, where the JAX package's is XLA's).

``--arms FILE`` writes every tiled arm that ran to a JSON sidecar, one
record each: ``{"matrix", "k", "alpha", "delta", "subpack", "dtype",
"gflops", "ms", "check"}`` (``run(records=...)`` collects them). The
echoed lines name no subpack, so ``tools.check_autotune`` reads the arms
from these records (``--arms``) where a skipped arm would shift its
positional parse; the result line is unchanged.

Two differences from ``bench.py``, so that no failure on the card is
hidden:

* Validation. The first fp32 arm of every (matrix, K), and every fp16 arm,
  is held against the fp64 oracle (``check_data``, the check that
  ``benchmark(validate=True)`` makes, on the CSR emission of the same
  plan). ``bench.py`` validates nothing. The oracle costs seconds per
  multi-million-nnz cell, so not every arm is validated.
* Failure. A cell that fails twice, or whose check is not ``pass``, is
  named in ``failed_cells`` (present only when non-empty), and the module
  exits 1 after printing the line. ``bench.py`` drops such a cell silently
  and exits 0.

Each cell's phases are timed with ``phase_timer``: generate (the matrix
and the dense operands), reorder, pack, upload, time (``benchmark``, which
packs and uploads its plan again, as bench.py's does), validate. Their
totals go to a stderr line before the JSON, one stderr line per arm before
that.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bsmr_sddmm_tpu_torch import datasets
from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR, make_dense
from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan, resolve_device
from bsmr_sddmm_tpu_torch.pack import TilePlan, pack_tiles
from bsmr_sddmm_tpu_torch.sddmm import BsmrSddmm
from bsmr_sddmm_tpu_torch.utils.compilecache import enable_compile_cache
from bsmr_sddmm_tpu_torch.utils.hostmem import rss_gb, tune_malloc
from bsmr_sddmm_tpu_torch.utils.profiling import phase_timer

KS = (32, 64, 128, 256)
ALPHAS = (0.1, 0.3, 0.5)
# (delta, subpack_min_nnz) arms for the full grid, as bench.py has them
# (TPU v5e break-evens: tiling paid from ~15-24 nonzeros a tile there).
CONFIGS = ((0.002, 0), (0.006, 0), (0.002, 12), (0.02, 12))
N_TRANSFER = 4          # full-grid mode: non-headline K re-times top-N
MAX_PLAN_BYTES = 1 << 30
#: reference per-K geomeans (RTX 4090, best-over-sweep per matrix)
BASELINE_GEOMEAN_GFLOPS = {32: 1851.0, 64: 2601.0, 128: 2927.0,
                           256: 2710.0}

# Best arm per (matrix, K) from the JAX package's round-4 full-grid sweep
# on a TPU v5e (results/v5e_r4/bench_fullgrid.log): (alpha, delta,
# subpack, fp16_won). fp16_won: the fp16-emission run of this combo beat
# every fp32 cell there, so the sweep times both the fp32 and fp16 arms and
# the fp32-only geomean stays attributable.
R4_BEST = {
    ("banded_mesh_12k", 32): (0.3, 0.006, 0, False),
    ("banded_mesh_12k", 64): (0.3, 0.006, 0, False),
    ("banded_mesh_12k", 128): (0.1, 0.006, 0, False),
    ("banded_mesh_12k", 256): (0.1, 0.002, 12, False),
    ("banded_mesh_20k", 32): (0.3, 0.006, 0, False),
    ("banded_mesh_20k", 64): (0.3, 0.006, 0, False),
    ("banded_mesh_20k", 128): (0.5, 0.002, 0, True),
    ("banded_mesh_20k", 256): (0.3, 0.006, 0, False),
    ("banded_mesh_32k", 32): (0.3, 0.002, 0, False),
    ("banded_mesh_32k", 64): (0.3, 0.002, 0, False),
    ("banded_mesh_32k", 128): (0.3, 0.002, 12, False),
    ("banded_mesh_32k", 256): (0.1, 0.002, 12, False),
    ("banded_mesh_64k", 32): (0.3, 0.006, 0, False),
    ("banded_mesh_64k", 64): (0.3, 0.006, 0, False),
    ("banded_mesh_64k", 128): (0.3, 0.006, 0, True),
    ("banded_mesh_64k", 256): (0.5, 0.006, 0, False),
    ("community_16k", 32): (0.1, 0.006, 0, False),
    ("community_16k", 64): (0.1, 0.006, 0, False),
    ("community_16k", 128): (0.1, 0.006, 0, True),
    ("community_16k", 256): (0.1, 0.006, 0, True),
    ("community_20k", 32): (0.1, 0.002, 12, False),
    ("community_20k", 64): (0.1, 0.002, 12, False),
    ("community_20k", 128): (0.1, 0.002, 12, True),
    ("community_20k", 256): (0.1, 0.002, 12, False),
    ("community_32k", 32): (0.5, 0.002, 0, False),
    ("community_32k", 64): (0.5, 0.002, 0, False),
    ("community_32k", 128): (0.1, 0.002, 0, True),
    ("community_32k", 256): (0.1, 0.006, 0, True),
    ("rmat_16", 32): (0.3, 0.002, 0, False),
    ("rmat_16", 64): (0.3, 0.002, 12, False),
    ("rmat_16", 128): (0.5, 0.002, 12, True),
    ("rmat_16", 256): (0.3, 0.002, 12, False),
}

PHASES = ("generate", "reorder", "pack", "upload", "time", "validate")


def plan_bytes(plan: TilePlan) -> int:
    """Bytes of the plan's int32 maps (bench.py's guard)."""
    return 4 * (plan.tile_scatter.size + plan.g_scatter.size
                + plan.sp_scatter.size + plan.sp_sub.size
                + plan.sp_colperm.size
                + plan.tile_cols.size + plan.g_cols.size
                + 3 * plan.res_arow.size + plan.rphm_to_csr.size)


def geomean(d: Dict[str, float]) -> float:
    xs = list(d.values())
    if not xs:
        return 0.0
    return float(np.exp(np.mean(np.log(np.maximum(xs, 1e-9)))))


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(suite: Sequence[Tuple[str, Callable[[], CSR]]],
        ks: Sequence[int] = KS, budget_s: float = 1500.0, device=None,
        full_grid: bool = False, extra_arms: bool = False,
        echo: Optional[Callable[[str], None]] = None,
        records: Optional[List[dict]] = None) -> dict:
    """Sweep ``suite`` ((name, generator) pairs named as in ``R4_BEST``)
    at ``ks`` on ``device`` (default: the card) and return the result
    line's dict. ``echo`` takes the per-arm and phase-total lines (default:
    stderr). ``records``, where given, gets one dict per tiled arm that
    ran and printed its line: ``matrix, k, alpha, delta, subpack, dtype``
    (``"float32"`` or ``"float16"``), ``gflops``, ``ms`` (``sddmm_ms``)
    and ``check`` (``"pass"``, ``"fail"``, or the unvalidated arm's
    value)."""
    if 128 not in ks:
        raise ValueError("ks must hold K=128, the headline")
    device = resolve_device(device)
    echo = echo or _stderr
    t_start = time.time()
    phases = {p: 0.0 for p in PHASES}
    best: Dict[int, Dict[str, float]] = {k: {} for k in ks}
    best32: Dict[int, Dict[str, float]] = {k: {} for k in ks}
    skipped_cells: List[str] = []
    failed_cells: List[str] = []

    def out_of_budget():
        return time.time() - t_start > budget_s

    for name, gen in suite:
        with phase_timer(phases, "generate"):
            csr = gen()
        base_cfg = SddmmConfig(k=128, panel_height=32, num_iterations=10,
                               reorder_cache=True)
        pipes: Dict[int, BsmrSddmm] = {}
        pipes16: Dict[int, BsmrSddmm] = {}
        validated = set()   # the K whose fp32 arm passed its check

        def get_pipe(sub, f16):
            pool = pipes16 if f16 else pipes
            if sub not in pool:
                pool[sub] = BsmrSddmm(csr, base_cfg.replace(
                    subpack_min_nnz=sub,
                    **({"out_dtype": "float16"} if f16 else {})),
                    device=device)
                if pipes:   # share one row-reordering cache across arms
                    pool[sub]._row_cache = \
                        next(iter(pipes.values()))._row_cache
            return pool[sub]

        def attempt(cell, fn):
            """``fn()``, retried once; None and ``cell`` named failed
            after a second exception."""
            for tries in (1, 2):
                try:
                    return fn()
                except Exception as e:   # a cell must not end the sweep
                    what = ("RETRY after" if tries == 1
                            else "FAILED twice, last")
                    echo(f"# {cell}: {what} {type(e).__name__}: {e}")
            failed_cells.append(cell)
            return None

        def run_one(K, ops, alpha, delta, sub, f16=False):
            A_np, B_np, A, Bt = ops
            pipe = get_pipe(sub, f16)
            tag = " dt=f16" if f16 else ""
            cell = f"{name}:k{K}:a{alpha}d{delta}s{sub}" + \
                (":f16" if f16 else "")
            with phase_timer(phases, "reorder"):
                reord = pipe.reorder(alpha, delta)
            with phase_timer(phases, "pack"):
                plan = pack_tiles(csr, reord, pipe.config, k=K)
            nbytes = plan_bytes(plan)
            if nbytes > MAX_PLAN_BYTES:
                echo(f"# {name} a={alpha} d={delta} k={K}: "
                     f"skipped (plan maps {nbytes >> 20} MB)")
                return None
            validate = f16 or K not in validated

            def measure():
                with phase_timer(phases, "time"):
                    log = pipe.benchmark(A, Bt, alpha=alpha, delta=delta,
                                         time_csr_emit=False, file=name)
                if validate:
                    with phase_timer(phases, "validate"):
                        out = pipe.compile(plan, emit="csr")(
                            A, Bt, device_plan(plan, device))
                        pipe._validate(log, A_np, B_np.T, out)
                return log

            log = attempt(cell, measure)
            if log is None:
                return None
            echo(f"# {log.file} a={alpha} d={delta} k={K}{tag}: "
                 f"{log.gflops:.0f} GFLOPS ({log.sddmm_ms:.3f} ms, "
                 f"dense {log.dense_nnz}, gath {log.gathered_nnz}, "
                 f"res {log.residual_nnz}, "
                 f"fill {log.average_tile_density:.4f}) packed "
                 f"{log.packed_nnz} G={log.extras['fat_group']} eager "
                 f"{float(log.extras['sddmm_eager_ms']):.3f} ms check "
                 f"{log.check_result}")
            if records is not None:
                records.append(dict(
                    matrix=name, k=K, alpha=alpha, delta=delta, subpack=sub,
                    dtype="float16" if f16 else "float32",
                    gflops=float(log.gflops), ms=float(log.sddmm_ms),
                    check=log.check_result))
            if validate:
                if log.check_result != "pass":
                    failed_cells.append(cell)
                    return None
                if not f16:
                    validated.add(K)
            return log.gflops

        def record(K, gf, f16):
            if gf is None:
                return
            best[K][name] = max(best[K].get(name, 0.0), gf)
            if not f16:
                best32[K][name] = max(best32[K].get(name, 0.0), gf)

        scores = {}   # full-grid mode: (alpha, config) -> K=128 gflops
        # K=128 first: it is the headline and seeds full-grid transfer
        for K in sorted(ks, key=lambda k: k != 128):
            if out_of_budget():
                skipped_cells.append(f"{name}:k{K}")
                continue
            with phase_timer(phases, "generate"):
                A_np = make_dense(csr.rows, K, seed=1337)
                B_np = np.ascontiguousarray(
                    make_dense(K, csr.cols, seed=1338).T)   # (N, K)
            with phase_timer(phases, "upload"):
                A = torch.from_numpy(A_np).to(device)
                Bt = torch.from_numpy(B_np).to(device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            ops = (A_np, B_np, A, Bt)
            if full_grid:
                if K == 128:
                    combos = [(a, c) for a in ALPHAS for c in CONFIGS]
                else:
                    combos = sorted(scores, key=scores.get,
                                    reverse=True)[:N_TRANSFER]
                best_combo, best_gf = None, 0.0
                for alpha, (delta, sub) in combos:
                    if out_of_budget():
                        skipped_cells.append(
                            f"{name}:k{K}:a{alpha}d{delta}s{sub}")
                        continue
                    gf = run_one(K, ops, alpha, delta, sub)
                    record(K, gf, f16=False)
                    if gf is not None and gf >= best_gf:
                        best_combo, best_gf = (alpha, (delta, sub)), gf
                    if K == 128 and gf is not None:
                        scores[(alpha, (delta, sub))] = gf
                if best_combo is not None and not out_of_budget():
                    alpha, (delta, sub) = best_combo
                    record(K, run_one(K, ops, alpha, delta, sub,
                                      f16=True), f16=True)
            else:
                alpha, delta, sub, f16_won = R4_BEST[(name, K)]
                record(K, run_one(K, ops, alpha, delta, sub), f16=False)
                if f16_won and not out_of_budget():
                    record(K, run_one(K, ops, alpha, delta, sub, f16=True),
                           f16=True)
                if extra_arms and not out_of_budget():
                    # autotuner challenger: its (alpha, delta) pick, timed
                    # only when it differs from the table
                    try:
                        choice = get_pipe(sub, False).choose(alpha="auto",
                                                             k=K)
                        pick = (choice.alpha, choice.plan.delta_used)
                    except Exception as e:
                        echo(f"# {name} k={K}: autotune failed "
                             f"({type(e).__name__}: {e})")
                        failed_cells.append(f"{name}:k{K}:auto")
                        pick = None
                    if pick is not None and pick != (alpha, delta):
                        record(K, run_one(K, ops, *pick, sub), f16=False)
            if name not in best[K]:
                if out_of_budget():
                    continue
                # every arm skipped/failed: dense-fallback so the geomean
                # reflects a real run instead of cratering
                pipe = get_pipe(0, False)

                def dense():
                    with phase_timer(phases, "time"):
                        log = pipe.benchmark(A, Bt, delta="dense",
                                             file=name)
                    with phase_timer(phases, "validate"):
                        pipe._validate(log, A_np, B_np.T,
                                       pipe.dense_fn(K)(A, Bt))
                    return log

                cell = f"{name}:k{K}:dense"
                log = attempt(cell, dense)
                if log is None:
                    continue
                echo(f"# {name} k={K}: all tiled plans skipped -> dense "
                     f"fallback {log.gflops:.0f} GFLOPS "
                     f"({log.sddmm_ms:.3f} ms) check {log.check_result}")
                if log.check_result != "pass":
                    failed_cells.append(cell)
                    continue
                best[K][name] = best32[K][name] = log.gflops

    echo("# phases (s): " + ", ".join(f"{p} {phases[p] / 1e3:.3f}"
                                      for p in PHASES)
         + f"; wall {time.time() - t_start:.3f} s; host RSS "
           f"{rss_gb():.2f} GiB; device {device}")
    g128 = geomean(best[128])
    out = {
        "metric": "sddmm_geomean_gflops_k128_suite8",
        "value": round(g128, 1),
        "unit": "GFLOPS",
        "vs_baseline": round(g128 / BASELINE_GEOMEAN_GFLOPS[128], 4),
        "per_k_geomean": {str(k): round(geomean(best[k]), 1) for k in ks},
        "per_k_vs_baseline": {str(k): round(geomean(best[k])
                                            / BASELINE_GEOMEAN_GFLOPS[k], 4)
                              for k in ks},
        # fp32-emission-only geomeans (the fp16-out arm excluded), so the
        # mixed headline is always attributable
        "per_k_geomean_fp32out": {str(k): round(geomean(best32[k]), 1)
                                  for k in ks},
        "matrices_per_k": {str(k): len(best[k]) for k in ks},
    }
    if skipped_cells:
        out["budget_skipped"] = skipped_cells
    if failed_cells:
        out["failed_cells"] = failed_cells
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="bsmr-bench-torch",
        description="SUITE bench of the port (bench.py's sweep and "
                    "result line); environment: BENCH_BUDGET_S, "
                    "BENCH_MATRICES, BENCH_FULL_GRID, BENCH_EXTRA_ARMS")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the bodies run (default: the card; cpu "
                        "runs the kernels' plain versions)")
    p.add_argument("--arms", default=None, metavar="FILE",
                   help="write each tiled arm that ran (matrix, k, alpha, "
                        "delta, subpack, dtype, gflops, ms, check) to FILE "
                        "as JSON, for tools.check_autotune --arms")
    args = p.parse_args(argv)
    tune_malloc()   # packing is allocation-bound on a small host
    enable_compile_cache()   # reuse the kernel build across runs
    only = os.environ.get("BENCH_MATRICES")   # comma-separated subset
    suite = [(n, g) for n, g in datasets.SUITE
             if only is None or n in only.split(",")]
    if not suite:
        print(f"BENCH_MATRICES={only!r} matched nothing; suite names: "
              f"{[n for n, _ in datasets.SUITE]}", file=sys.stderr)
        return 1
    records: List[dict] = []
    out = run(suite, budget_s=float(os.environ.get("BENCH_BUDGET_S",
                                                   "1500")),
              device=args.device,
              full_grid=bool(os.environ.get("BENCH_FULL_GRID")),
              extra_arms=bool(os.environ.get("BENCH_EXTRA_ARMS")),
              records=records)
    if args.arms:
        os.makedirs(os.path.dirname(args.arms) or ".", exist_ok=True)
        with open(args.arms, "w") as f:
            json.dump(records, f, indent=1)
    if not out["matrices_per_k"]["128"]:
        print("no cells measured", file=sys.stderr)
        return 1
    print(json.dumps(out))
    return 1 if "failed_cells" in out else 0


if __name__ == "__main__":
    sys.exit(main())
