"""Refit the tier cost table from audit cells (offline least squares): the
port of ``scripts/fit_costs_from_audit.py``.

    python -m bsmr_sddmm_tpu_torch.tools.fit_costs_from_audit \
        [--audit build/arm_audit/cost_model_audit.json] \
        [--write-cache DEVICE_NAME] [--device cpu]

The model is LINEAR in its constants: for a cell with plan stats (tiles T,
fat group G, gathered Tg, residual E, contraction K),

  ms = fixed + T*(fb + fk*K) + (T/G)*(sb + sk*K)
       + Tg*(gb + gk*K) + E*(rb + rk*K)

so all nine constants solve in one weighted least squares over the audit
rows (weights 1/measured: it minimizes RELATIVE error, else the big cells
dominate). Windowed rows are left out. A negative solution is clamped to
the ``V5E_COSTS`` default: a negative rate is the fit borrowing a term it
cannot see.

The design has no packed-tier term, though ``estimate_plan_ms`` has one
(``Tp * packed`` and the ``colperm_row_ns`` gather), and none for fp16's
``out_save_ns``: fit only rows of subpack-0, fp32 runs (an audit of a log
made with ``bench.replica_suite --configs 0.002:0 0.006:0``), as the JAX
package's round 2 did.

Prints the quality before and after (geomean |log ratio| per K) and the
table; ``--write-cache NAME`` writes the table, less ``fixed_us`` as in the
JAX script, to the autotune cost cache of device ``NAME``
(``autotune._cache_path``, which ``current_costs()`` reads on that card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

from bsmr_sddmm_tpu_torch.autotune import V5E_COSTS, _cache_path
from bsmr_sddmm_tpu_torch.ops.sddmm import resolve_device
from bsmr_sddmm_tpu_torch.tools import add_device_arg

NAMES = ("fixed_ms", "dense_floor_base_ns", "dense_floor_k_ns",
         "dense_step_base_ns", "dense_step_k_ns",
         "gathered_base_ns", "gathered_k_ns",
         "pernnz_base_ns", "pernnz_k_ns")


def design_row(r, k):
    T, G = r["tiles"], max(r["fat_group"], 1)
    Tg, E = r["gathered"], r["residual"]
    return [1.0,                       # fixed (ms)
            T, T * k,                  # dense floor base/k (ns)
            T / G, T / G * k,          # step base/k
            Tg, Tg * k,                # gathered base/k
            E, E * k]                  # pernnz base/k


def fit(rows: List[dict], defaults: dict = V5E_COSTS) -> dict:
    """The refit over the audit ``rows`` (those with a ratio, not
    windowed): ``{"table", "quality": {"defaults", "refit"}}``. The table
    is in ``V5E_COSTS``' units (``fixed_us``, the rest ns)."""
    rows = [r for r in rows if r.get("ratio") and not r.get("windowed")]
    A = np.array([design_row(r, r["k"]) for r in rows])
    y = np.array([r["measured_ms"] for r in rows])
    w = 1.0 / y
    sol, *_ = np.linalg.lstsq(A * w[:, None], y * w, rcond=None)
    # constants are in mixed units: fixed in ms, the rest ns * count/1e6
    solved = dict(zip(NAMES, sol))
    base = dict(fixed_ms=defaults["fixed_us"] / 1e3,
                **{n: defaults[n] * 1e-6 for n in NAMES[1:]})
    clamped = {n: (solved[n] if solved[n] > 0 else base[n]) for n in NAMES}
    pred0 = A @ np.array([base[n] for n in NAMES])
    pred1 = A @ np.array([clamped[n] for n in NAMES])

    def quality(pred):
        out = {}
        for k in sorted({r["k"] for r in rows}):
            sel = [i for i, r in enumerate(rows) if r["k"] == k]
            lr = np.abs(np.log(y[sel] / np.maximum(pred[sel], 1e-9)))
            out[str(k)] = round(float(np.exp(np.mean(lr))), 3)
        return out

    table = {"fixed_us": round(clamped["fixed_ms"] * 1e3, 2),
             **{n: round(clamped[n] * 1e6, 4) for n in NAMES[1:]}}
    return {"table": table,
            "quality": {"defaults": quality(pred0),
                        "refit": quality(pred1)}}


def write_cache(table: dict, device_name: str) -> str:
    """Write ``table`` less ``fixed_us`` to ``device_name``'s cost cache."""
    path = _cache_path(device_name)
    with open(path, "w") as f:
        json.dump({k: v for k, v in table.items() if k != "fixed_us"}, f)
    return path


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        description="least-squares refit of the tier cost table from an "
                    "audit")
    p.add_argument("--audit", default=os.path.join(
        "build", "arm_audit", "cost_model_audit.json"))
    p.add_argument("--write-cache", default=None, metavar="DEVICE_NAME",
                   help="write the refit table to the autotune cost "
                        "cache for this device name (else report only)")
    add_device_arg(p)
    args = p.parse_args(argv)
    resolve_device(args.device)

    with open(args.audit) as f:
        got = fit(json.load(f)["rows"])
    print("geomean |ratio| error per K (1.0 = perfect):")
    print("  defaults:", json.dumps(got["quality"]["defaults"]))
    print("  refit:   ", json.dumps(got["quality"]["refit"]))
    print(json.dumps(got["table"], indent=1))
    if args.write_cache:
        print("wrote", write_cache(got["table"], args.write_cache))
    return 0


if __name__ == "__main__":
    sys.exit(main())
