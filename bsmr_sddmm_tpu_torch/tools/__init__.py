"""Arm-selection and harness tools: the port's counterparts of the JAX
package's ``scripts/``, one module per script and named after it.

- ``check_autotune``: the priced pick against the measured sweep best;
- ``audit_cost_model``: the price against the measured time of every
  logged arm;
- ``probe_tier_calibration``: the per-tier split of the worst-priced cells;
- ``fit_costs_from_audit``: a least-squares refit of the nine constants,
  optionally written to the autotune cost cache;
- ``probe_refine_pick``: the host pick and the refined pick against the
  swept best;
- ``profile_tiers``: the per-tier breakdown across the suite's regimes;
- ``prewarm_reorder_cache``: the replicas' row reorderings into the cache;
- ``predict_scaling``: the analytic weak-scaling model over the suite;
- ``run_weak_scaling``: weak scaling of the sharded SDDMM.

Each module has plain functions (the tests and ``chip_smoke.py`` call them)
and a ``main(argv=None)``, run as ``python -m
bsmr_sddmm_tpu_torch.tools.<name>``. Every ``main`` takes ``--device``:
the card by default, the CPU only with ``--device cpu``; without a card
and without ``--device cpu`` it raises (``ops.sddmm.resolve_device``).
Where a JAX script wrote into ``results/v5e_r*/``, the default path here
lies under ``build/`` (gitignored). Every cost constant these tools start
from (``autotune.V5E_COSTS``) was measured on a TPU v5e.
"""

from __future__ import annotations

import argparse


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", choices=["cuda", "cpu"], default=None,
                        help="where the tool runs (default: the card; cpu "
                             "runs the kernels' plain versions)")


def add_costs_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--costs", choices=["v5e", "current"],
                        default="v5e",
                        help="the price table: autotune.V5E_COSTS (default) "
                             "or autotune.current_costs(), the card's "
                             "cached table where one exists")


def costs_of(args: argparse.Namespace) -> dict:
    from bsmr_sddmm_tpu_torch import autotune
    return (autotune.current_costs() if args.costs == "current"
            else autotune.V5E_COSTS)
