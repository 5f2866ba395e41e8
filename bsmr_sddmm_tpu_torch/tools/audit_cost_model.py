"""Cost-model audit, price against measured time: the port of
``scripts/audit_cost_model.py``.

    python -m bsmr_sddmm_tpu_torch.tools.audit_cost_model \
        [--log-root build/arm_audit] [--dataset-dir build/replica_dataset] \
        [--out build/arm_audit/cost_model_audit.json] [--subpack 0] \
        [--costs v5e|current] [--device cpu]

For every bsmr record (matrix, K, alpha, delta) of the replica-suite logs
(``<log-root>/logs*/BSMR_*.log``, the ``RunLog`` text that
``bench.replica_suite`` appends) the plan is rebuilt host-side from the
cached replica and reorder caches (packing is deterministic), priced with
``autotune.estimate_plan_ms`` and compared with the measured ``sddmm_ms``
in the log. Output: per-cell ratios, per-K and per-(regime, K) summaries
and the worst cells, as JSON: where the affine tier model is wrong.

``--subpack`` is one value for the whole log, as in the JAX script, while
the replica suite sweeps subpack 0 and 12 into one log by default: audit a
log made with ``--configs`` of a single subpack value (``0.002:0 0.006:0``
for ``--subpack 0``).

``audit`` takes the records and a ``plan_for`` function, so arms just
timed can be audited without a log directory (``chip_smoke.py`` does).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Callable, List

import numpy as np

from bsmr_sddmm_tpu_torch.autotune import V5E_COSTS, estimate_plan_ms
from bsmr_sddmm_tpu_torch.ops.sddmm import resolve_device
from bsmr_sddmm_tpu_torch.tools import (add_costs_arg, add_device_arg,
                                        costs_of)

FIELD = re.compile(r"\[(\w+) : ([^\]]+)\]")
OUT_DIR = os.path.join("build", "arm_audit")


def parse_records(log_root: str) -> List[dict]:
    """-> [{file, k, alpha, delta, ms, ...}] from BSMR_*.log files."""
    recs = []
    for path in sorted(glob.glob(os.path.join(log_root, "logs*",
                                              "BSMR_*.log"))):
        with open(path) as f:
            text = f.read()
        for block in text.split("---New data---"):
            fields = dict(FIELD.findall(block))
            if "bsmr_sddmm" not in fields:
                continue
            recs.append(dict(
                file=fields["File"].replace(".mtx", ""),
                k=int(fields["K"]),
                alpha=float(fields["alpha"]),
                delta=float(fields["delta"]),
                ms=float(fields["bsmm_sddmm"]
                         if "bsmm_sddmm" in fields
                         else fields["bsmr_sddmm"]),
                dense_blocks=int(fields.get("numDenseBlocks", 0)),
                gathered_blocks=int(fields.get("numGatheredBlocks", 0)),
                residual_nnz=int(fields.get("residualNNZ", 0)),
            ))
    return recs


def replica_planner(dataset_dir: str, subpack: int) -> Callable:
    """``plan_for(record) -> (plan, regime)`` over the manifest replicas
    (None for a matrix the manifest lacks), one pipeline per matrix."""
    from bsmr_sddmm_tpu_torch.config import SddmmConfig
    from bsmr_sddmm_tpu_torch.replicas import (load_manifest,
                                               make_replica_cached)
    from bsmr_sddmm_tpu_torch.sddmm import BsmrSddmm

    specs = {s.name: s for s in load_manifest()}
    pipes = {}

    def plan_for(r):
        spec = specs.get(r["file"])
        if spec is None:
            return None
        if r["file"] not in pipes:
            csr = make_replica_cached(spec, dataset_dir)
            pipes[r["file"]] = BsmrSddmm(
                csr, SddmmConfig(k=128, panel_height=32,
                                 subpack_min_nnz=subpack,
                                 reorder_cache=True))
        return (pipes[r["file"]].plan(r["alpha"], r["delta"], k=r["k"]),
                spec.regime)

    return plan_for


def summary(sel) -> dict:
    ratios = np.array([x["ratio"] for x in sel if x["ratio"]])
    if not ratios.size:
        return None
    return dict(n=int(ratios.size),
                geomean=round(float(np.exp(np.mean(np.log(ratios)))), 3),
                median=round(float(np.median(ratios)), 3),
                p10=round(float(np.percentile(ratios, 10)), 3),
                p90=round(float(np.percentile(ratios, 90)), 3),
                max=round(float(ratios.max()), 3),
                min=round(float(ratios.min()), 3))


def audit(records: List[dict], plan_for: Callable, costs: dict = V5E_COSTS,
          echo: Callable[[str], None] = print) -> dict:
    """Price each record's plan with ``costs`` against its measured ms.
    ``plan_for(record)`` returns ``(plan, regime)``, or None to leave the
    record out; a record whose plan fails to pack is left out with a line
    on stderr."""
    rows = []
    for r in sorted(records, key=lambda r: (r["file"], r["k"])):
        try:
            got = plan_for(r)
        except Exception as e:   # one bad cell must not end the audit
            print(f"# {r['file']} k={r['k']} d={r['delta']}: pack "
                  f"failed ({e})", file=sys.stderr, flush=True)
            continue
        if got is None:
            continue
        plan, regime = got
        est = estimate_plan_ms(plan, costs)
        rows.append(dict(
            matrix=r["file"], regime=regime, k=r["k"],
            alpha=r["alpha"], delta=r["delta"],
            measured_ms=r["ms"], est_ms=round(est, 4),
            ratio=round(r["ms"] / est, 3) if est else None,
            tiles=int(plan.tile_panel.shape[0]),
            fat_group=int(plan.fat_group),
            gathered=int(plan.num_gathered),
            residual=int(plan.num_residual),
            windowed=plan.window_rows is not None,
        ))
        echo(f"{r['file']} k={r['k']} a={r['alpha']} d={r['delta']}: "
             f"measured {r['ms']:.3f} est {est:.3f} "
             f"ratio {rows[-1]['ratio']}")

    ks = sorted({x["k"] for x in rows})
    per_k = {str(k): summary([x for x in rows if x["k"] == k]) for k in ks}
    per_regime_k = {
        reg: {str(k): summary([x for x in rows
                               if x["k"] == k and x["regime"] == reg])
              for k in ks}
        for reg in sorted({x["regime"] for x in rows})}
    worst = sorted([x for x in rows if x["ratio"]],
                   key=lambda x: -abs(np.log(x["ratio"])))[:15]
    return dict(note=("measured/est ratio per (matrix, K, alpha, delta); "
                      "ratio > 1 = model too optimistic"),
                cells=len(rows), per_k=per_k, per_regime_k=per_regime_k,
                worst=worst, rows=rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="price against measured time over replica-suite logs")
    p.add_argument("--log-root", default=OUT_DIR,
                   help="holds logs*/BSMR_*.log (bench.replica_suite "
                        "--log-dir <log-root>/logs_k128, ...)")
    p.add_argument("--dataset-dir",
                   default=os.path.join("build", "replica_dataset"))
    p.add_argument("--out", default=os.path.join(OUT_DIR,
                                                 "cost_model_audit.json"))
    p.add_argument("--subpack", type=int, default=0,
                   help="subpack_min_nnz the logged runs used")
    add_costs_arg(p)
    add_device_arg(p)
    args = p.parse_args(argv)
    resolve_device(args.device)
    from bsmr_sddmm_tpu_torch.utils.hostmem import tune_malloc
    tune_malloc()

    recs = parse_records(args.log_root)
    print(f"{len(recs)} measured records", flush=True)
    out = audit(recs, replica_planner(args.dataset_dir, args.subpack),
                costs_of(args), echo=lambda m: print(m, flush=True))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"per_k": out["per_k"]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
