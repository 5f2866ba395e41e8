"""Analytic multi-chip scaling model from per-shard plan statistics.

A copy of ``bsmr_sddmm_tpu.parallel.scaling_model`` (plain NumPy), so that
this package prices shard plans exactly as the JAX package does. It prices
with the JAX package's TPU v5e tier table (``autotune.V5E_COSTS``) and v5e
ICI ring rates (``ICI_RING_GBPS``): every number it returns is a
prediction for a TPU v5e ring, not for the card, and nothing in this
package claims it as a card's number. What it computes exactly is the
*structure* that determines scaling:

* **Compute balance.** ``pack_shard_plans`` splits row panels into
  cost-balanced contiguous ranges, but tile/residual counts per shard are
  not perfectly balanced; each shard's predicted kernel time comes from
  the per-tier cost table (:func:`autotune.estimate_plan_ms`), and a
  sharded step runs at the SLOWEST shard.
  imbalance = max(shard_ms) / mean(shard_ms).
* **Communication.** The b-sharded layouts move each B panel to every
  device once: the ring transfers (n-1) hops of w*K*4 bytes per device
  (:mod:`bsmr_sddmm_tpu_torch.parallel.ring`), concurrently with
  per-panel compute. Overlapped, the step is comm-bound only when a
  hop's transfer outlasts the panel's compute.

Together these yield a predicted weak-scaling efficiency
``T(1) / T(n) = mean(shard_ms) / max(max(shard_ms), comm_bound_ms)``
for the *same-work-per-device* regime. The model is a quantified
structural argument, NOT a measurement — every output is labeled
``predicted_*`` and carries its assumptions (link rate, cost table).

ICI rate default: 45 GB/s per link per direction, 2 links usable for a
1-D ring on a v5e 2-D torus (the public v5e spec sheet's 1,600 Gbps
aggregate = 4 links x 2 directions x 50 GB/s).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from bsmr_sddmm_tpu_torch.autotune import V5E_COSTS, estimate_plan_ms
from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.pack import pack_shard_plans
from bsmr_sddmm_tpu_torch.reorder import BsmrReordering

#: conservative per-device ring bandwidth over ICI (bytes ride both ring
#: directions on a torus; see module docstring)
ICI_RING_GBPS = 90.0


@dataclasses.dataclass
class ScalingPrediction:
    n: int
    k: int
    shard_ms: list               # predicted per-shard kernel ms
    imbalance: float             # max / mean of shard_ms
    hop_bytes: int               # per ring hop per device (w * K * 4)
    comm_ms: float               # (n-1) hops at the ring rate
    efficiency_overlapped: float    # ring: comm hidden under compute
    efficiency_blocking: float      # all-gather-first layout (lower bound)

    def to_dict(self) -> dict:
        return {
            "n": self.n, "k": self.k,
            "shard_ms": [round(s, 4) for s in self.shard_ms],
            "predicted_imbalance": round(self.imbalance, 4),
            "hop_bytes": self.hop_bytes,
            "predicted_comm_ms": round(self.comm_ms, 4),
            "predicted_efficiency_overlapped":
                round(self.efficiency_overlapped, 4),
            "predicted_efficiency_blocking":
                round(self.efficiency_blocking, 4),
        }


def predict_weak_scaling(csr: CSR, reord: BsmrReordering,
                         config: SddmmConfig, n: int,
                         k: Optional[int] = None,
                         costs: dict = V5E_COSTS,
                         ici_gbps: float = ICI_RING_GBPS
                         ) -> ScalingPrediction:
    """Predict the weak-scaling efficiency of the per-shard-packed
    sharded SDDMM on an ``n``-device ring, from this matrix's actual
    shard plans and the measured single-chip cost table.

    Weak scaling here means each device keeps this matrix's per-shard
    work (the reference-suite regime where the mask grows with the
    mesh): efficiency = per-device time at n=1 over the n-device step
    time, i.e. mean(shard_ms) / max(slowest shard, comm bound).
    """
    k = config.k if k is None else k
    plans = pack_shard_plans(csr, reord, config, n, k=k)
    shard_ms = [estimate_plan_ms(p, costs) for p in plans]
    mean_ms = float(np.mean(shard_ms))
    max_ms = float(np.max(shard_ms))
    # ring hop: one B panel (w rows x K) per device per step
    w = -(-csr.cols // n)
    hop_bytes = w * k * 4
    hop_ms = hop_bytes / (ici_gbps * 1e6)
    comm_ms = (n - 1) * hop_ms
    # overlapped (ring): each of the n steps takes
    # max(per-panel compute, hop transfer); per-panel compute ~= the
    # shard's total / n for this structural estimate
    step_compute = max_ms / n
    t_overlap = n * max(step_compute, hop_ms)
    # blocking (all_gather-first): full B arrives before any compute
    t_block = comm_ms + max_ms
    return ScalingPrediction(
        n=n, k=k, shard_ms=shard_ms,
        imbalance=max_ms / mean_ms if mean_ms else 1.0,
        hop_bytes=hop_bytes, comm_ms=comm_ms,
        efficiency_overlapped=mean_ms / t_overlap if t_overlap else 0.0,
        efficiency_blocking=mean_ms / t_block if t_block else 0.0,
    )


@dataclasses.dataclass
class LayoutChoice:
    """Cost-model pick between the two multi-chip B layouts."""
    layout: str                  # "ring" | "allgather"
    t_ring_ms: float             # predicted n-device step time, ring
    t_allgather_ms: float        # predicted step time, all-gather-first
    prediction_ring: ScalingPrediction
    prediction_allgather: ScalingPrediction

    def to_dict(self) -> dict:
        return {"layout": self.layout,
                "predicted_t_ring_ms": round(self.t_ring_ms, 4),
                "predicted_t_allgather_ms":
                    round(self.t_allgather_ms, 4),
                "ring": self.prediction_ring.to_dict(),
                "allgather": self.prediction_allgather.to_dict()}


def choose_layout(csr: CSR, reord: BsmrReordering, config: SddmmConfig,
                  n: int, k: Optional[int] = None,
                  costs: dict = V5E_COSTS,
                  ici_gbps: float = ICI_RING_GBPS) -> LayoutChoice:
    """Pick the multi-chip B layout for this matrix: the ppermute ring
    (B stays sharded, transfers hidden under compute) or the blocking
    all-gather (full B on every device before compute).

    The ring has no packed (hot-column) tier — it would need a global
    column permutation of the B rows, which no device holds
    (parallel/ring.py module docstring: plans leaning on the tier
    "should prefer the all-gather layout — the cost model's call").
    This function IS that call: the all-gather arm is priced on the
    shard plans as packed (packed tier intact, full comm up front); the
    ring arm on plans packed with the tier off (its nonzeros fall to the
    gathered/per-nnz tiers, as the ring packer routes them), with each
    hop overlapped against one panel's compute. Approximation: ring
    compute is modeled from the row-shard plans, not the ring packer's
    per-(shard, B-panel) groups — same tiles, coarser grouping."""
    k = config.k if k is None else k
    pred_ag = predict_weak_scaling(csr, reord, config, n, k=k,
                                   costs=costs, ici_gbps=ici_gbps)
    pred_ring = (pred_ag if not config.subpack_min_nnz else
                 predict_weak_scaling(csr, reord,
                                      config.replace(subpack_min_nnz=0),
                                      n, k=k, costs=costs,
                                      ici_gbps=ici_gbps))
    hop_ms = pred_ring.comm_ms / max(n - 1, 1)
    t_ring = n * max(max(pred_ring.shard_ms) / n, hop_ms)
    t_ag = pred_ag.comm_ms + max(pred_ag.shard_ms)
    return LayoutChoice(
        layout="ring" if t_ring <= t_ag else "allgather",
        t_ring_ms=t_ring, t_allgather_ms=t_ag,
        prediction_ring=pred_ring, prediction_allgather=pred_ag)


def predict_suite(generators, config: SddmmConfig,
                  ns: Sequence[int] = (2, 4, 8),
                  k: Optional[int] = None,
                  ici_gbps: float = ICI_RING_GBPS) -> dict:
    """Run :func:`predict_weak_scaling` over named mask generators.
    Returns {matrix: {n: prediction dict}} plus the model assumptions."""
    from bsmr_sddmm_tpu_torch.reorder import bsmr
    out = {"assumptions": {
        "ici_ring_gbps": ici_gbps,
        "cost_table": "autotune.V5E_COSTS (measured v5e tier rates)",
        "note": "predicted from per-shard plan statistics, NOT measured "
                "on multi-chip hardware (unavailable: 1 chip)",
    }}
    for name, gen in generators:
        csr = gen()
        reord = bsmr(csr, config)
        out[name] = {
            str(n): predict_weak_scaling(
                csr, reord, config, n, k=k,
                ici_gbps=ici_gbps).to_dict()
            for n in ns}
        # which B layout the cost model would pick at the largest mesh
        # (ring keeps B sharded but has no packed tier — choose_layout
        # docstring)
        out[name]["layout_choice"] = choose_layout(
            csr, reord, config, max(ns), k=k,
            ici_gbps=ici_gbps).to_dict()
    return out
