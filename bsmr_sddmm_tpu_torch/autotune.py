"""Cost-model arm selection: delta, alpha and subpack, and the dense
fallback.

The counterpart of ``bsmr_sddmm_tpu.autotune``. The CUDA original finds each
matrix's best (alpha, delta) by running the full sweep on hardware
(scripts/run_BSMR.sh: 140 configurations per matrix). Here a plan's runtime
is *predicted* from its tier counts,

    T_dense * tile_ns / fat_factor  +  Tg * gathered_tile_ns
      + E * pernnz_ns  +  fixed dispatch

``choose_delta`` / ``choose_config`` pack a handful of candidates (NumPy, no
device work) and return the argmin; ``refine_top`` re-times the best-priced
plans on the card and keeps the measured argmin.

The host half (the cost tables, candidate sets, ``estimate_*``,
``choose_*``, ``_merge_costs``) is a copy of the JAX package's and gives
the same floats and picks on the same plans (tests/test_torch_autotune.py).
Every constant in ``V5E_COSTS`` is a TPU v5e measurement, and so are the
break-evens behind ``DELTA_CANDIDATES``, ``ALPHA_CANDIDATES`` and
``BIG_GATHER_BYTES``: none is a fact about an NVIDIA GPU. ``calibrate()``
refits the four tier lines (dense floor, packed, gathered, per-nnz) on the
card in use and caches them by device name; ``sampled_dot_tflops`` (the
dense arm's rate), ``fixed_us``, the dense step and the ``_big`` arms stay
v5e values even then.

The device half is ported: ``current_costs`` reads the card's cache
(``tier_costs_<device name>.json`` under ``BSMR_CACHE_DIR``, else ``build/``
at the checkout root), ``_refine_measure`` times candidates with CUDA
events, ``calibrate`` times each tier alone as a replayed CUDA graph.
Unlike the JAX package, a candidate that fails to build or launch raises
instead of keeping its estimate.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR, make_dense, random_mask
from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan, make_sddmm_body
from bsmr_sddmm_tpu_torch.pack import TilePlan, pack_tiles
from bsmr_sddmm_tpu_torch.reorder import BsmrReordering, bsmr, split_columns
from bsmr_sddmm_tpu_torch.utils.timing import (time_cuda, time_cuda_graph,
                                               time_host)

#: Measured v5e tier costs: per-unit cost is an affine function of K
#: (cost = base + k_slope * K), because each tier's bytes scale with K
#: while its descriptor/pipeline terms do not. The checked-in values are
#: DMA-model fits anchored to K=128 measurements on the TPU (dense
#: 52 + 208/G ns/tile, gathered ~470 ns, pernnz ~5.8 ns); calibrate()
#: refits base and slope from K=32 and K=128 runs on the live device.
V5E_COSTS = dict(
    # dense BSR tile floor: out tile (ph*bw*4 bytes) + A panel (ph*K*4)
    # at stream rate -> 26 + 0.2*K (52 at K=128, matching the measured
    # fat-step fit 52 + 208/G)
    dense_floor_base_ns=26.0,
    dense_floor_k_ns=0.20,
    # per-STEP overhead (divide by fat group G): pipeline bubble + the
    # shared B block DMA (bw*K*4 bytes) -> 108 + 0.79*K (208 at K=128)
    dense_step_base_ns=108.0,
    dense_step_k_ns=0.79,
    # hot-column packed tile (G=1): floor + step overhead + S contiguous
    # (sw, K) B block slices of Bt2 (measured 173/179/226 ns/tile at
    # K=32/128/256 on v5e)
    packed_base_ns=158.0,
    packed_k_ns=0.26,
    # the ONE per-call Bt2 = take(Bt, colperm) gather: per-row descriptor
    # cost (row bytes ride at full gather bandwidth)
    colperm_row_ns=2.9,
    # gathered tile: 128-row-gather descriptors (K-independent) + B/out
    # bytes (measured ~470 ns at K=128)
    gathered_base_ns=370.0,
    gathered_k_ns=0.80,
    gathered_big_base_ns=1000.0,  # past the >64MB gather cliff (windowed)
    gathered_big_k_ns=0.80,
    # per-nnz residual: two row-gather descriptors, measured
    # K-independent up to K=256 (descriptor-bound)
    pernnz_base_ns=5.8,
    pernnz_k_ns=0.0,
    # windowed residual (past the >64MB gather cliff): measured 45 ns/nnz
    # at K=256 on banded_mesh_64k (results/v5e_r4/k32_anomaly_tiers.json:
    # 3.8 ms over 85k nnz) vs the flat 9 ns before window slicing made the
    # per-nnz gathers K-byte-bound, so the big arm carries a real K slope
    pernnz_big_base_ns=9.0,
    pernnz_big_k_ns=0.14,
    fixed_us=150.0,           # dispatch / A-permute / padding floor
    mxu_tflops=55.0,          # bf16x3 effective fp32-class matmul rate
    stream_gbps=645.0,        # contiguous HBM read+write
    elem_gather_meps=140.0,   # 4-byte element gather (M elem/s)
    # effective rate of the dense-fallback tier (XLA sampled dense dot,
    # bcoo_dot_general_sampled): the full M*N*K product with fused
    # extraction. Measured 13-32 TFLOP/s on v5e depending on mask
    # structure; the conservative end keeps the arm from firing unless
    # it clearly wins.
    sampled_dot_tflops=13.0,
)

#: Legacy single-K key aliases (older disk caches may carry these);
#: mapped onto the affine model at K=128 by current_costs().
_LEGACY_KEYS = {
    "dense_tile_floor_ns": ("dense_floor_base_ns", "dense_floor_k_ns"),
    "dense_step_overhead_ns": ("dense_step_base_ns", "dense_step_k_ns"),
    "packed_tile_ns": ("packed_base_ns", "packed_k_ns"),
    "gathered_tile_ns": ("gathered_base_ns", "gathered_k_ns"),
    "pernnz_ns": ("pernnz_base_ns", "pernnz_k_ns"),
}

DELTA_CANDIDATES = (0.002, 0.006, 0.02, 0.05, 0.15, 0.3)
#: the CUDA original sweeps alpha in {.1,.3,.5,.7,.9} on hardware
#: (src/sddmm.cu:64); on this row clustering the .5+ perms are usually
#: identical to .5 (they get deduped by row_perm hash), so the priced set
#: mirrors the JAX package's measured sweep
ALPHA_CANDIDATES = (0.1, 0.3, 0.5)


def estimate_dense_ms(rows: int, cols: int, nnz: int, k: int,
                      costs: dict = V5E_COSTS) -> float:
    """Predicted time for the dense-fallback tier: the JAX package's
    sampled dense dot computes the full M*N*K product with the mask
    extraction fused (the product is never materialized in HBM), so the
    cost is one flops term at the measured effective rate."""
    flops_ms = 2.0 * rows * cols * k / (costs["sampled_dot_tflops"] * 1e9)
    return flops_ms + costs["fixed_us"] / 1e3


def _affine(costs: dict, prefix: str, k: int) -> float:
    return costs[f"{prefix}_base_ns"] + costs[f"{prefix}_k_ns"] * k


#: Row-gather operands at/past ~48 MB ran near the >64 MB gather-cliff
#: rate on v5e even without windowing: banded_mesh_64k K=256 (B exactly
#: 64 MB, unwindowed) measured 45-48 ns per residual nonzero vs the
#: 5.8 ns small-operand rate (results/v5e_r4/k32_anomaly_tiers.json).
#: Those plans are priced with the _big arms too.
BIG_GATHER_BYTES = 48 << 20


def _big_gather_footprint(plan: TilePlan) -> bool:
    return plan.cols * plan.k * 4 >= BIG_GATHER_BYTES


def estimate_plan_ms(plan: TilePlan,
                     costs: dict = V5E_COSTS,
                     out_dtype: str = "float32") -> float:
    """Predicted kernel time (rphm emit) for one packed plan. Every tier
    cost is affine in K (bytes scale with K; descriptors do not), so one
    cost table prices all of K in {32..256}.

    ``out_dtype="float16"`` subtracts half the per-tile output-byte term
    (ph*bw*2 bytes at stream rate) from every tiled tier — fp16 emission
    halves the store, shifting the delta optimum slightly toward more
    tiles."""
    k = plan.k
    big = plan.window_rows is not None or _big_gather_footprint(plan)
    out_save_ns = 0.0
    if out_dtype == "float16":
        out_save_ns = (plan.panel_height * plan.block_width * 2
                       / costs["stream_gbps"])
    dense_ns = (_affine(costs, "dense_floor", k) - out_save_ns
                + _affine(costs, "dense_step", k) / max(plan.fat_group, 1))
    g_ns = _affine(costs, "gathered_big" if big else "gathered",
                   k) - out_save_ns
    e_ns = _affine(costs, "pernnz_big" if big else "pernnz", k)
    colperm_rows = (plan.sp_colperm.shape[0]
                    if plan.sp_colperm is not None and plan.num_packed
                    else 0)
    total_ns = (plan.tile_panel.shape[0] * dense_ns
                + plan.num_packed * _affine(costs, "packed", k)
                + colperm_rows * costs["colperm_row_ns"]
                + plan.num_gathered * g_ns
                + plan.num_residual * e_ns
                + costs["fixed_us"] * 1e3)
    return total_ns / 1e6


@dataclasses.dataclass
class DeltaChoice:
    delta: float
    estimated_ms: float
    plan: TilePlan
    candidates: dict  # delta -> estimated ms; key "dense" = fallback arm
    use_dense: bool = False   # dense-fallback tier beats every tiled plan


def choose_delta(csr: CSR, reord: BsmrReordering, config: SddmmConfig,
                 candidates: Sequence[float] = DELTA_CANDIDATES,
                 k: Optional[int] = None,
                 allow_dense: bool = True) -> DeltaChoice:
    """Pack each candidate delta (host-side only) and return the one with
    the lowest predicted kernel time, along with its plan.

    A further arm competes with every tiled plan: the dense-fallback tier
    (``BsmrSddmm.dense_fn``). The CUDA original's hybrid ablation shows its
    TC-only column sometimes beating hybrid
    (scripts/results_suiteSparse_dataset/k32/results_hybrid_32.csv); this
    takes that to the matrix level. The arm is only offered for
    cols <= ~8M, as in the JAX package."""
    k_eff = config.k if k is None else k
    costs = current_costs()   # disk-cached per-device calibration if any
    best: Optional[Tuple[float, float, TilePlan]] = None
    table = {}
    # the packed tier competes per matrix: it won +20-25% on hub-heavy
    # masks on v5e and was neutral-to-slightly-negative where the residual
    # is singleton-dominated, so every delta is priced with the tier on
    # AND off
    subs = ((config.subpack_min_nnz, 0) if config.subpack_min_nnz
            else (0,))
    for d in candidates:
        r = split_columns(csr, dataclasses.replace(reord), config, delta=d)
        for sub in subs:
            plan = pack_tiles(csr, r, config.replace(subpack_min_nnz=sub),
                              k=k)
            ms = estimate_plan_ms(plan, costs,
                                  out_dtype=config.out_dtype)
            table[(d, sub)] = ms
            if best is None or ms < best[1]:
                best = (d, ms, plan)
    use_dense = False
    if allow_dense and csr.cols <= (1 << 23):
        dense_ms = estimate_dense_ms(csr.rows, csr.cols, csr.nnz, k_eff,
                                     costs)
        table["dense"] = dense_ms
        if dense_ms < best[1]:
            use_dense = True
            return DeltaChoice(delta=best[0], estimated_ms=dense_ms,
                               plan=best[2], candidates=table,
                               use_dense=True)
    return DeltaChoice(delta=best[0], estimated_ms=best[1], plan=best[2],
                       candidates=table, use_dense=use_dense)


@dataclasses.dataclass
class ConfigChoice:
    """Argmin of the priced (alpha, delta, subpack) grid."""
    alpha: float
    delta: float
    subpack: int
    estimated_ms: float
    plan: TilePlan
    candidates: dict   # (alpha, delta, subpack) -> ms; "dense" = fallback
    use_dense: bool = False


def choose_config(csr: CSR, row_reorder_fn, config: SddmmConfig,
                  alphas: Sequence[float] = ALPHA_CANDIDATES,
                  candidates: Sequence[float] = DELTA_CANDIDATES,
                  k: Optional[int] = None,
                  allow_dense: bool = True,
                  refine_top: int = 0,
                  device=None) -> ConfigChoice:
    """Price the full (alpha, delta, subpack) grid host-side and return
    the argmin — the autotuned equivalent of the CUDA original's
    alpha x delta test-mode hardware sweep (src/sddmm.cu:64-66).

    ``row_reorder_fn(alpha)`` supplies the row clustering (cached
    upstream: ``BsmrSddmm._row_reordering``; clustering dominates
    preprocessing, so the caller owns the cache). Alphas whose row
    permutation equals an already-priced alpha's are skipped: identical
    perms mean identical plans at every delta.

    ``refine_top=N`` (N >= 2) re-times candidate plans on ``device`` with
    CUDA events and picks the measured argmin; the measured times join
    the table as ``("measured", alpha, delta, subpack)``. On a CPU device,
    or with no device, the estimate order stands. The candidate set is
    DIVERSIFIED, not top-N-by-estimate: the union of the best-priced plan
    per (delta, subpack) family and the best-priced plan per alpha,
    capped at N by estimate order, since the model's bias is not confined
    to one axis. The dense-fallback arm still competes by estimate
    only."""
    k_eff = config.k if k is None else k
    costs = current_costs()
    subs = ((config.subpack_min_nnz, 0) if config.subpack_min_nnz
            else (0,))
    table = {}
    # per-(delta, sub) family best: family -> (ms, alpha, delta, sub, plan)
    fam_best = {}
    seen_perms = set()
    for alpha in alphas:
        reord = row_reorder_fn(alpha)
        perm_key = hash(reord.row_perm.tobytes())
        if perm_key in seen_perms:
            continue
        seen_perms.add(perm_key)
        for d in candidates:
            r = split_columns(csr, dataclasses.replace(reord), config, delta=d)
            for sub in subs:
                plan = pack_tiles(
                    csr, r, config.replace(subpack_min_nnz=sub), k=k)
                ms = estimate_plan_ms(plan, costs,
                                      out_dtype=config.out_dtype)
                table[(alpha, d, sub)] = ms
                # without refinement only the global best plan is
                # retained (memory: plans are the big objects); with it,
                # the per-family and per-alpha bests stay alive for the
                # measured pass
                if refine_top >= 2:
                    fams = ((d, sub), ("alpha", alpha))
                else:
                    fams = ("best",)
                for fam in fams:
                    cur = fam_best.get(fam)
                    if cur is None or ms < cur[0]:
                        fam_best[fam] = (ms, alpha, d, sub, plan)
    # union-dedup (one plan can head several families)
    uniq = {}
    for entry in fam_best.values():
        uniq[entry[1:4]] = entry
    kept = sorted(uniq.values(), key=lambda t: t[0])
    if refine_top >= 2 and len(kept) >= 2:
        measured = _refine_measure(kept[:int(refine_top)], config, k_eff,
                                   device)
        if measured:   # (ms, alpha, d, sub, plan) by measured time
            for ms, alpha, d, sub, _ in measured:
                table[("measured", alpha, d, sub)] = ms
            kept = measured + kept[int(refine_top):]
    best = kept[0]
    use_dense = False
    estimated = best[0]
    if allow_dense and csr.cols <= (1 << 23):
        dense_ms = estimate_dense_ms(csr.rows, csr.cols, csr.nnz, k_eff,
                                     costs)
        table["dense"] = dense_ms
        if dense_ms < best[0]:
            use_dense = True
            estimated = dense_ms
    return ConfigChoice(alpha=best[1], delta=best[2], subpack=best[3],
                        estimated_ms=estimated, plan=best[4],
                        candidates=table, use_dense=use_dense)


def _refine_measure(kept, config: SddmmConfig, k: int, device):
    """Time each candidate plan's rphm body on ``device`` (CUDA events,
    ``max(4, num_iterations // 2)`` calls); return the list re-sorted by
    measured ms, or None when ``device`` is not a CUDA device (the
    estimate ordering is kept). A candidate that fails to build or launch
    raises: a kernel fault must not hide behind an estimate."""
    if device is None or torch.device(device).type != "cuda":
        return None
    device = torch.device(device)
    # operands: deterministic fills at the plan's shapes (timing is
    # value-independent)
    plan0 = kept[0][4]
    m, n = plan0.rows, plan0.cols
    A = torch.from_numpy(make_dense(m, k, seed=1337)).to(device)
    Bt = torch.from_numpy(make_dense(k, n, seed=1338).T.copy()).to(device)
    out = []
    for _, alpha, d, sub, plan in kept:
        cfg = config.replace(subpack_min_nnz=sub)
        body = make_sddmm_body(plan, cfg, None, emit="rphm")
        dplan = device_plan(plan, device, emit="rphm")
        ms, _ = time_cuda(body, A, Bt, dplan,
                          iterations=max(4, config.num_iterations // 2))
        out.append((ms, alpha, d, sub, plan))
    out.sort(key=lambda t: t[0])
    return out


# ---------------------------------------------------------------------------
# Runtime calibration: V5E_COSTS are one TPU's measurements; refit the four
# tier lines on the card in use once and cache them to disk keyed by the
# device name.
# ---------------------------------------------------------------------------

_CALIBRATED: Optional[dict] = None

#: the keys calibrate() refits and stores
CALIBRATED_KEYS = tuple(f"{p}_{s}_ns" for p in ("dense_floor", "packed",
                                                "gathered", "pernnz")
                        for s in ("base", "k"))


def _cache_path(device_kind: str) -> str:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = os.environ.get("BSMR_CACHE_DIR") or os.path.join(root, "build")
    os.makedirs(base, exist_ok=True)
    safe = "".join(c if c.isalnum() else "_" for c in device_kind)
    return os.path.join(base, f"tier_costs_{safe}.json")


def current_costs() -> dict:
    """The cost table in effect: calibrated values when available
    (memory, then the card's disk cache), else the checked-in v5e
    measurements. Without CUDA it is ``V5E_COSTS``."""
    global _CALIBRATED
    if _CALIBRATED is not None:
        return _CALIBRATED
    if not torch.cuda.is_available():
        return V5E_COSTS
    path = _cache_path(torch.cuda.get_device_name())
    if os.path.exists(path):
        with open(path) as f:
            _CALIBRATED = _merge_costs(json.load(f))
        return _CALIBRATED
    return V5E_COSTS


def _merge_costs(loaded: dict) -> dict:
    """Overlay a disk cache onto the defaults. Older caches carried
    single-K keys anchored at K=128; they map onto the affine model by
    keeping the default slope and shifting the base."""
    merged = dict(V5E_COSTS)
    for key, val in loaded.items():
        if key in _LEGACY_KEYS:
            base_key, slope_key = _LEGACY_KEYS[key]
            merged[base_key] = val - merged[slope_key] * 128.0
        else:
            merged[key] = val
    return merged


def _store_costs(costs: dict, device_kind: str) -> str:
    """Write the refit keys of ``costs`` to the device's cache file."""
    path = _cache_path(device_kind)
    with open(path, "w") as f:
        json.dump({k: costs[k] for k in CALIBRATED_KEYS}, f)
    return path


def _fit_affine(costs: dict, prefix: str, pairs) -> None:
    """Fit ``costs[prefix_base_ns] + costs[prefix_k_ns] * k`` to
    ``pairs`` [(k, per_unit_ns or None)]: slope clamped >= 0, base >= 0.5;
    one pair keeps the slope and shifts the base; none leaves both."""
    pairs = [(k, v) for k, v in pairs if v is not None]
    if not pairs:
        return
    if len(pairs) == 1:
        k0, v0 = pairs[0]
        costs[f"{prefix}_base_ns"] = max(
            v0 - costs[f"{prefix}_k_ns"] * k0, 0.5)
        return
    karr = np.array([p[0] for p in pairs], float)
    varr = np.array([p[1] for p in pairs], float)
    slope, base = np.polyfit(karr, varr, 1)
    costs[f"{prefix}_k_ns"] = max(float(slope), 0.0)
    costs[f"{prefix}_base_ns"] = max(float(base), 0.5)


def _time_tier(body, A, Bt, dplan) -> float:
    """Milliseconds per call of one tier's body: on the card, a CUDA graph
    of one call, the median of 5 rounds of 50 replays; the host clock over
    8 calls on the CPU.
    A lone tier of a calibration plan runs for 0.02-0.1 ms on an H100,
    less than the host takes to enqueue its ops, so per-call CUDA events
    time the host (2x spread over repeats); the graph times the device,
    as the JAX package times its tiers in-program for the same reason."""
    if A.is_cuda:
        return time_cuda_graph(body, A, Bt, dplan, iterations=50)[0]
    return time_host(body, A, Bt, dplan, iterations=8)[0]


CALIBRATION_KS = (32, 128)


def calibrate(store: bool = True, ks=CALIBRATION_KS) -> dict:
    """Measure the four tier costs on the CUDA card (the CPU without one)
    at each K in ``ks`` (small synthetic plans, each tier timed alone
    through ``make_sddmm_body(..., only_tier=tier)``) and fit the affine
    base + slope*K model per tier. On the card the result is cached to
    disk keyed by the device name. Returns the refit cost table, which
    also becomes ``current_costs()`` in this process."""
    global _CALIBRATED
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    costs = dict(V5E_COSTS)

    def tier_per_unit(csr, config, tier, delta, k):
        config = config.replace(k=k)
        reord = bsmr(csr, config.replace(delta=delta))
        plan = pack_tiles(csr, reord, config)
        body = make_sddmm_body(plan, config, only_tier=tier)
        A = torch.from_numpy(make_dense(csr.rows, k, seed=1)).to(device)
        Bt = torch.from_numpy(make_dense(csr.cols, k, seed=2)).to(device)
        ms = _time_tier(body, A, Bt, device_plan(plan, device, emit="rphm"))
        units = {"dense": plan.tile_panel.shape[0],
                 "packed": plan.sp_panel.shape[0],
                 "gathered": plan.g_panel.shape[0],
                 "residual": plan.res_arow.shape[0]}[tier]
        return (ms * 1e6 / units if units else None), plan

    # 1. dense BSR tiles: blocky mask, everything tiled. The lumped
    # per-tile cost is floor(K) + step(K)/G; subtract the default step
    # model to recover the floor line.
    csr_d = random_mask(8192, 8192, 1_000_000, seed=3, block_rows=32,
                        block_cols=256, block_fill=0.8)
    cfg = SddmmConfig(k=128, panel_height=32)
    dense_pairs = []
    for k in ks:
        per, plan = tier_per_unit(csr_d, cfg, "dense", 0.02, k)
        if per is not None:
            G = max(plan.fat_group, 1)
            step = (costs["dense_step_base_ns"]
                    + costs["dense_step_k_ns"] * k) / G
            dense_pairs.append((k, max(per - step, 0.5)))
    _fit_affine(costs, "dense_floor", dense_pairs)
    # 2. packed sub-block tiles: block mask below the BSR threshold
    csr_p = random_mask(8192, 8192, 500_000, seed=5, block_rows=32,
                        block_cols=32, block_fill=0.6)
    cfg_p = cfg.replace(delta=1.1, residual_tile_min_nnz=1 << 30)
    _fit_affine(costs, "packed",
                [(k, tier_per_unit(csr_p, cfg_p, "packed", 1.1, k)[0])
                 for k in ks])
    # 3. gathered tiles: uniform-ish mask, low tile cutoff, subpack off
    cfg_g = cfg.replace(residual_tile_min_nnz=16, subpack_min_nnz=0)
    csr_g = random_mask(8192, 8192, 600_000, seed=4)
    _fit_affine(costs, "gathered",
                [(k, tier_per_unit(csr_g, cfg_g, "gathered", 0.02, k)[0])
                 for k in ks])
    # 4. per-nnz residual
    cfg_r = cfg.replace(residual_mode="pernnz", subpack_min_nnz=0)
    _fit_affine(costs, "pernnz",
                [(k, tier_per_unit(csr_g, cfg_r, "residual", 1.1, k)[0])
                 for k in ks])

    _CALIBRATED = costs
    if store and device.type == "cuda":
        _store_costs(costs, torch.cuda.get_device_name(device))
    return costs
