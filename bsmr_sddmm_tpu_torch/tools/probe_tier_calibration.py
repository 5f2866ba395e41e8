"""Per-tier timing of the cost model's worst-priced cells: the port of
``scripts/probe_tier_calibration.py``.

    python -m bsmr_sddmm_tpu_torch.tools.probe_tier_calibration \
        [--audit build/arm_audit/cost_model_audit.json] \
        [--out build/arm_audit/tier_calibration.json] \
        [--dataset-dir build/replica_dataset] [--top 10] [--device cpu]

From an audit (``tools.audit_cost_model``), ``pick_cells`` takes the worst
|log ratio| cells, each K's worst first. Each cell runs
``benchmark(tier_times=True)`` (every tier alone, a replayed CUDA graph on
the card) beside host-side structure: tiles, steps, B-block refetches and
the dense tier's bytes, with the rate those bytes imply. On the dense-heavy
cell with the worst ratio, the dense tier alone at forced fat groups
G in 1, 4, 8, 16, 32 (``utils.timing.time_cuda_graph`` of the body with
``only_tier="dense"``, where the JAX script used ``time_tier_inprogram``)
says whether its cost is per step or per tile, and the same tier on the
plain versions (``backend="torch"``, ``torch.bmm``) stands where the JAX
script timed its XLA arm against Pallas.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Callable, List

from bsmr_sddmm_tpu_torch.ops.sddmm import resolve_device
from bsmr_sddmm_tpu_torch.tools import add_device_arg

OUT_DIR = os.path.join("build", "arm_audit")
G_SWEEP = (1, 4, 8, 16, 32)


def pick_cells(audit: dict, top: int):
    """Worst |log ratio| cells overall plus each K's worst, deduped by
    (matrix, k) — one delta per pair is enough to attribute the miss."""
    rows = [r for r in audit["rows"] if r.get("ratio")]
    rows.sort(key=lambda r: -abs(math.log(r["ratio"])))
    picked, seen = [], set()
    per_k_worst = {}
    for r in rows:
        per_k_worst.setdefault(r["k"], r)
    for r in list(per_k_worst.values()) + rows:
        key = (r["matrix"], r["k"])
        if key in seen:
            continue
        seen.add(key)
        picked.append(r)
        if len(picked) >= top:
            break
    return picked


def _time_tier(body, A, Bt, dplan) -> float:
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda_graph, time_host
    timer = time_cuda_graph if A.is_cuda else time_host
    return timer(body, A, Bt, dplan, iterations=20)[0]


def probe(audit: dict, top: int, dataset_dir: str, device,
          echo: Callable[[str], None] = print) -> List[dict]:
    """One row per picked cell, then the G sweep's row (where a cell's
    dense tier holds more than half its time)."""
    import torch

    from bsmr_sddmm_tpu_torch.autotune import estimate_plan_ms
    from bsmr_sddmm_tpu_torch.config import SddmmConfig
    from bsmr_sddmm_tpu_torch.formats import make_dense
    from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan, make_sddmm_body
    from bsmr_sddmm_tpu_torch.pack import pack_tiles
    from bsmr_sddmm_tpu_torch.replicas import (load_manifest,
                                               make_replica_cached)
    from bsmr_sddmm_tpu_torch.sddmm import BsmrSddmm

    cells = pick_cells(audit, top)
    specs = {s.name: s for s in load_manifest()}
    out_rows, pipes = [], {}
    for c in cells:
        spec = specs[c["matrix"]]
        if c["matrix"] not in pipes:
            csr = make_replica_cached(spec, dataset_dir)
            pipes[c["matrix"]] = BsmrSddmm(
                csr, SddmmConfig(k=c["k"], panel_height=32,
                                 subpack_min_nnz=0, reorder_cache=True),
                device=device)
        pipe = pipes[c["matrix"]]
        csr = pipe.csr
        A = make_dense(csr.rows, c["k"], seed=1337)
        B = make_dense(c["k"], csr.cols, seed=1338)
        log = pipe.benchmark(A, B, alpha=c["alpha"], delta=c["delta"],
                             tier_times=True, time_csr_emit=False,
                             file=c["matrix"])
        plan = pipe.plan(c["alpha"], c["delta"], k=c["k"])
        # host-side structure: the dense tier's exact traffic, so a miss
        # can be told apart as bandwidth or as per-step latency
        T = int(plan.tile_panel.shape[0])
        sc = plan.step_cblock
        refetch = (1 + int((sc[1:] != sc[:-1]).sum())
                   if sc is not None else T)
        ph, bw = plan.panel_height, plan.block_width
        dense_bytes = (T * ph * c["k"] * 4          # A panel reads
                       + refetch * bw * c["k"] * 4  # B block reads
                       + T * ph * bw * 4)           # out tiles
        row = {"matrix": c["matrix"], "regime": c["regime"],
               "k": c["k"], "alpha": c["alpha"], "delta": c["delta"],
               "audit_ratio": c["ratio"],
               "measured_ms": log.sddmm_ms,
               "est_ms": round(estimate_plan_ms(plan), 4),
               "tiles": T,
               "fat_group": int(plan.fat_group),
               "steps": T // max(int(plan.fat_group), 1),
               "b_refetches": refetch,
               "dense_dma_mb": round(dense_bytes / 1e6, 1),
               "num_panels": int(plan.num_panels),
               "gathered": int(plan.num_gathered),
               "residual": int(plan.num_residual),
               **{key: log.extras.get(key) for key in
                  ("tier_dense_ms", "tier_packed_ms",
                   "tier_gathered_ms", "tier_residual_ms",
                   "tier_overlap_efficiency")}}
        if row.get("tier_dense_ms") and float(row["tier_dense_ms"]) > 0:
            row["dense_implied_gbps"] = round(
                dense_bytes / 1e6 / float(row["tier_dense_ms"]), 1)
        out_rows.append(row)
        echo(json.dumps(row))
    # --- fat-group sweep on the worst dense-heavy cell ------------------
    # per-step cost falls as G grows; per-tile cost (or B-block locality)
    # does not
    dense_heavy = [r for r in out_rows
                   if r.get("tier_dense_ms")
                   and float(r["tier_dense_ms"]) > 0.5 * r["measured_ms"]]
    if dense_heavy:
        r0 = max(dense_heavy, key=lambda r: r["audit_ratio"])
        pipe = pipes[r0["matrix"]]
        csr = pipe.csr
        reord = pipe.reorder(r0["alpha"], r0["delta"])
        A = torch.from_numpy(make_dense(csr.rows, r0["k"],
                                        seed=1337)).to(device)
        Bt = torch.from_numpy(make_dense(csr.cols, r0["k"],
                                         seed=1338)).to(device)
        sweep = []
        for G in G_SWEEP:
            plan = pack_tiles(csr, reord, pipe.config, k=r0["k"],
                              fat_group_override=G)
            if plan.fat_group != G:
                continue
            body = make_sddmm_body(plan, pipe.config, only_tier="dense")
            ms = _time_tier(body, A, Bt,
                            device_plan(plan, device, emit="rphm"))
            sweep.append({"G": G,
                          "tiles": int(plan.tile_panel.shape[0]),
                          "dense_ms": round(ms, 4),
                          "ns_per_tile": round(
                              ms * 1e6 / plan.tile_panel.shape[0], 1)})
            echo(json.dumps(sweep[-1]))
        # the hand kernel against the plain versions on the same tier
        plan = pipe.plan(r0["alpha"], r0["delta"], k=r0["k"])
        plain = make_sddmm_body(plan, pipe.config, backend="torch",
                                only_tier="dense")
        plain_ms = _time_tier(plain, A, Bt,
                              device_plan(plan, device, emit="rphm"))
        echo(json.dumps({"torch_dense_ms": round(plain_ms, 4)}))
        out_rows.append({"matrix": r0["matrix"], "k": r0["k"],
                         "alpha": r0["alpha"], "delta": r0["delta"],
                         "fat_group_sweep": sweep,
                         "torch_dense_ms": round(plain_ms, 4)})
    return out_rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="per-tier timing of an audit's worst-priced cells")
    p.add_argument("--audit", default=os.path.join(
        OUT_DIR, "cost_model_audit.json"))
    p.add_argument("--out", default=os.path.join(
        OUT_DIR, "tier_calibration.json"))
    p.add_argument("--dataset-dir",
                   default=os.path.join("build", "replica_dataset"))
    p.add_argument("--top", type=int, default=10)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    from bsmr_sddmm_tpu_torch.utils.hostmem import tune_malloc
    tune_malloc()   # packing is allocation-bound on a small host
    from bsmr_sddmm_tpu_torch.utils.compilecache import enable_compile_cache
    enable_compile_cache()   # reuse the kernel build across runs

    with open(args.audit) as f:
        audit = json.load(f)
    out_rows = probe(audit, args.top, args.dataset_dir, device,
                     echo=lambda m: print(m, flush=True))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out_rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
