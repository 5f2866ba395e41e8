"""Analytic weak-scaling predictions for the bench suite: the port of
``scripts/predict_scaling.py``.

    python -m bsmr_sddmm_tpu_torch.tools.predict_scaling \
        [OUT=build/scaling_model.json] [--device cpu]

A thin wrapper over ``parallel.scaling_model.predict_suite``: per-shard
kernel times priced from plan statistics with ``autotune.V5E_COSTS`` and a
TPU v5e ring rate. It measures nothing and claims nothing about a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from bsmr_sddmm_tpu_torch.ops.sddmm import resolve_device
from bsmr_sddmm_tpu_torch.tools import add_device_arg


def predict(suite) -> dict:
    """``predict_suite`` over ``suite`` at the JAX script's config."""
    from bsmr_sddmm_tpu_torch.config import SddmmConfig
    from bsmr_sddmm_tpu_torch.parallel.scaling_model import predict_suite
    cfg = SddmmConfig(k=128, panel_height=32, delta=0.006,
                      reorder_cache=True)
    return predict_suite(suite, cfg)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="the scaling model's predictions over the suite")
    p.add_argument("out", nargs="?",
                   default=os.path.join("build", "scaling_model.json"))
    add_device_arg(p)
    args = p.parse_args(argv)
    resolve_device(args.device)
    from bsmr_sddmm_tpu_torch.datasets import SUITE
    from bsmr_sddmm_tpu_torch.utils.hostmem import tune_malloc
    tune_malloc()

    preds = predict(SUITE)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(preds, f, indent=1)
    for name, per_n in preds.items():
        if name == "assumptions":
            continue
        effs = {n: p["predicted_efficiency_overlapped"]
                for n, p in per_n.items() if n != "layout_choice"}
        print(name, effs,
              "layout:", per_n["layout_choice"]["layout"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
