#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bsmr_sddmm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card. Phases:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc compiles csrc/*.cu for sm_90a (into build/torch_kernels/);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes of plans packed from the SUITE matrix banded_mesh_32k at
   K=128 and K=32 (fp32 and fp16 output), with max errors; the kernel's
   time (a replayed CUDA graph, twice, in turns with the others) beside
   its bound (dense_kernels.tile_work: the least time an H100 could take
   for this launch's bytes and operations), its share of the bound, the
   time of one library call (torch.bmm in fp32 on operands gathered
   before the timed window) and the plain version's: bsr_dense and subpack
   on bsr plans (the plan's fat group G and G=1), dense_tile,
   fused_gathered and subpack on col_mode="reorder" plans (alpha 0.3,
   delta 0.05), whose packed tier is the larger;
4. main path: BsmrSddmm(csr, cfg).benchmark(A, B, validate=True) at K=128
   on banded_mesh_32k and community_20k: the bsr path (and once with fp16
   output), the reorder path with the fused gathered tier (once with
   tier_times), and the bsr path with the fused gathered tier. Every run
   must pass check_data against the fp64 oracle, and the launch counters
   of the kernels it runs, set to 0 just before it, must rise during it;
   then one pipe.run() per run counts each kernel's launches per call,
   and torch.profiler over 20 calls of the bsr and the reorder body on
   banded_mesh_32k gives device busy time, host enqueue time, each
   device kernel's share and the index_select calls per call ([profile]);
5. autotune: on banded_mesh_32k and community_20k at K=128, subpack 12,
   BsmrSddmm.choose(alpha="auto", refine_top=4) priced with V5E_COSTS: the
   pick of its estimates, each candidate's measured ms and the measured
   pick; then benchmark(alpha="auto", delta="auto", validate=True), each
   pick's sddmm_ms beside the fixed arm's of phase 4;
6. calibrate: autotune.calibrate() on the card (BSMR_CACHE_DIR in a
   temporary directory), each point timed twice, the table held to its
   points (the byte-bound tiers' slopes above 0) and printed key by key
   next to V5E_COSTS, and both matrices re-priced with it;
7. dense: the dense fallback (delta="dense") and the best tiled plan
   priced with V5E_COSTS, at its (delta, subpack), on
   datasets.uniform(4096, 350_000) at K=128 with validate=True, and the
   cost model's choice there and on a blocky mask;
8. CLI: python -m bsmr_sddmm_tpu_torch.cli -f <suite matrix .mtx> -k 128
   -a 0.3 -d 0.002 --validate exits 0, and so do the run with
   --col-mode reorder -d 0.05 --evaluate --tier-times --reorder-cache
   (BSMR_CACHE_DIR in a temporary directory) and the run with --auto-alpha
   --refine-top 3, which writes the BSMR_k_128_a_auto_d_auto log.

Every phase that runs the pipeline sets the launch counters to 0 just before
it and requires a launch of each kernel its plans use just after.

The last lines are the nvidia-smi line, a JSON line with one record per
kernel, and {"ok": true, "device": {...}}. Any failure, or no CUDA device,
exits non-zero before them. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PKG = "bsmr_sddmm_tpu_torch"

# kernel-vs-plain tolerance: |kernel - plain| <= ATOL + RTOL * |plain|.
# fp32: both sides sum K <= 256 products of values in [0, 2) in fp32. The
# plain version is an fp32 bmm (allow_tf32 False); all four kernels run on
# tensor cores in three TF32 passes, which drop only the lo*lo term of each
# product (~2^-22 relative) and sum in another order, so they agree to a
# few fp32 ulps of the sum, not bit for bit.
# fp16: each side rounds its fp32 sum to fp16 once, so they differ by at
# most one fp16 ulp (rel 2^-10), which is the check_data tolerance (abs
# 1e-5 OR rel 1e-3).
TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
       "float16": dict(rtol=1e-3, atol=1e-5)}
KERNELS = {
    "bsr_dense": dict(source=f"{PKG}/csrc/bsr_dense.cu",
                      replaces="bsmr_sddmm_tpu/ops/pallas_dense.py:466"),
    "subpack": dict(source=f"{PKG}/csrc/subpack.cu",
                    replaces="bsmr_sddmm_tpu/ops/pallas_dense.py:315"),
    "dense_tile": dict(source=f"{PKG}/csrc/gathered_tile.cu",
                       replaces="bsmr_sddmm_tpu/ops/pallas_dense.py:238"),
    "fused_gathered": dict(source=f"{PKG}/csrc/gathered_tile.cu",
                           replaces="bsmr_sddmm_tpu/ops/pallas_dense.py:405"),
}
# the main path's runs, K=128, ph=32, subpack 12: (SUITE matrix, alpha,
# delta, out dtype, col_mode, gathered_backend, tier_times, the kernels the
# run must launch). The bsr runs take delta 0.002 (the JAX package's best
# arm for them, bench.py R4_BEST); the reorder runs delta 0.05 / 0.1, where
# every tier of the plan has real tiles (the CUDA original's delta 0.3
# leaves banded_mesh_32k no dense tile at ph=32, bw=128).
BSR, REORDER = ("bsr_dense", "subpack"), ("dense_tile", "subpack")
MAIN = (("banded_mesh_32k", 0.3, 0.002, "float32", "bsr", "xla", False, BSR),
        ("community_20k", 0.1, 0.002, "float32", "bsr", "xla", False, BSR),
        ("banded_mesh_32k", 0.3, 0.002, "float16", "bsr", "xla", False, BSR),
        ("banded_mesh_32k", 0.3, 0.05, "float32", "reorder", "fused", True,
         REORDER + ("fused_gathered",)),
        ("community_20k", 0.3, 0.1, "float32", "reorder", "fused", False,
         REORDER + ("fused_gathered",)),
        ("community_20k", 0.1, 0.002, "float32", "bsr", "fused", False,
         BSR + ("fused_gathered",)))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def import_port():
    """The port from this checkout, never an installed copy."""
    sys.path.insert(0, str(HERE))
    try:
        import bsmr_sddmm_tpu_torch as bt
    except ImportError as e:
        fail(f"cannot import {PKG} beside this script ({e})")
    if Path(bt.__file__).resolve().parent.parent != HERE:
        fail(f"{PKG} imported from {bt.__file__}, not from {HERE}")
    return bt


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def compare(torch, got, want, out_dtype):
    """(max_abs, max_rel, ok) of kernel output ``got`` vs plain ``want``."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        return float("inf"), float("inf"), False
    diff = (got - want).abs()
    denom = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    tol = TOL[out_dtype]
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= tol["atol"] + tol["rtol"] * want.abs()).all())
    return float(diff.max()), float((diff / denom).max()), ok


def covered_rows(torch, ids, width, limit):
    """Rows of an operand that blocks ``ids`` of ``width`` rows reference,
    each once, rows at or past ``limit`` not counted."""
    first = torch.unique(ids).long() * width
    return int((first + width).clamp(max=limit).sub(first).clamp(min=0).sum())


def launch_work(torch, dk, name, args, kw, out_dtype):
    """dense_kernels.tile_work of one launch: every operand row it
    references counted once, the index arrays once, the output once.
    ``args`` are the wrapper's: (A_panels, B, ..., panel ids, B ids)."""
    A_panels, B = args[:2]
    panel, src = args[-2:]
    ph, k = A_panels.shape[1], A_panels.shape[2]
    a_rows = int(torch.unique(panel).numel()) * ph
    index_bytes = 4 * (panel.numel() + src.numel())
    if name == "bsr_dense":
        bw = kw["block_width"]
        b_rows = covered_rows(torch, src, bw, B.shape[0])
    else:
        if name == "subpack":
            # the slots of sp_colperm that the sub-blocks name, then the
            # rows of Bt those slots name
            colperm, sw = args[2], kw["subblock_width"]
            bw = src.shape[1] * sw
            slots = (torch.unique(src).long()[:, None] * sw
                     + torch.arange(sw, device=src.device)).reshape(-1)
            slots = slots[(slots >= 0) & (slots < colperm.numel())]
            index_bytes += 4 * slots.numel()
            ids = torch.unique(colperm[slots])
        else:
            bw = src.shape[1]
            ids = torch.unique(src)
        b_rows = int(((ids >= 0) & (ids < B.shape[0])).sum())
    return dk.tile_work(panel.shape[0], ph, bw, k, out_dtype, a_rows=a_rows,
                        b_rows=b_rows, index_bytes=index_bytes)


def library_operands(torch, name, args, kw):
    """(a, b) with ``torch.bmm(a, b.mT)`` equal to the kernel's function:
    the operands gathered outside the timed window, so the library call is
    the product alone."""
    import torch.nn.functional as F
    A_panels, B = args[:2]
    panel, src = args[-2:]
    k = B.shape[1]
    a = A_panels.index_select(0, panel)
    if name in ("dense_tile", "fused_gathered"):
        ids = src.reshape(-1).long()
        ids = torch.where((ids >= 0) & (ids < B.shape[0]), ids, B.shape[0])
        return a, F.pad(B, (0, 0, 0, 1)).index_select(0, ids).reshape(
            src.shape[0], src.shape[1], k)
    if name == "subpack":
        B, width = B.index_select(0, args[2]), kw["subblock_width"]
    else:
        width = kw["block_width"]
    n_blocks = -(-B.shape[0] // width)
    blocks = F.pad(B, (0, 0, 0, n_blocks * width - B.shape[0])).reshape(
        n_blocks, width, k)
    if name == "bsr_dense":
        return a, blocks.index_select(
            0, src.repeat_interleave(kw["fat_group"]))
    return a, blocks.index_select(0, src.reshape(-1)).reshape(
        src.shape[0], -1, k)


def check_case(torch, dk, results, name, label, args, kw, keep):
    """One kernel at one plan's shapes, fp32 and fp16 output: against its
    plain version, and timed beside its bound, the library call and the
    plain version. ``keep``: these are the times of the kernels line."""
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda, time_cuda_graph
    kern, plain = getattr(dk, name), getattr(dk, f"{name}_plain")
    failures = []
    a, b = library_operands(torch, name, args, kw)
    for od in ("float32", "float16"):
        dt = getattr(torch, od)
        got = kern(*args, out_dtype=dt, **kw)
        want = plain(*args, out_dtype=dt, **kw)
        torch.cuda.synchronize()
        max_abs, max_rel, ok = compare(torch, got, want, od)
        work = launch_work(torch, dk, name, args, kw, dt)
        # in turns: kernel, library, plain, kernel. A launch of 0.05 ms is
        # shorter than its enqueue, so the short ones replay a CUDA graph
        first, _ = time_cuda_graph(lambda: kern(*args, out_dtype=dt, **kw))
        lib_ms = None
        if od == "float32":
            lib_ms, lib = time_cuda_graph(lambda: torch.bmm(a, b.mT))
            if compare(torch, lib, want, od)[2] is False:
                failures.append(f"library call differs: {name} {label}")
            del lib
        plain_ms, _ = time_cuda(lambda: plain(*args, out_dtype=dt, **kw),
                                iterations=20)
        again, _ = time_cuda_graph(lambda: kern(*args, out_dtype=dt, **kw))
        ms = (first + again) / 2
        say(f"[kernels]   {name} {label} {od} out={tuple(got.shape)}: "
            f"max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
            f"{'ok' if ok else 'MISMATCH'}; kernel {ms:.4f} ms ({first:.4f}, "
            f"{again:.4f}); bound {work['bound_ms']:.4f} ms "
            f"({work['bound_by']}: {work['bytes'] / 1e6:.1f} MB, "
            f"{work['flops'] / 1e9:.2f} GFLOP x 3 passes), share of bound "
            f"{work['bound_ms'] / ms:.0%}; library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}; plain "
            f"{plain_ms:.4f} ms")
        if not ok:
            failures.append(f"{name} {label} {od}")
        rec = results[name]
        if od == "float32":
            rec["max_abs_err"] = max(rec["max_abs_err"], max_abs)
            if keep:
                rec.update(ms=ms, plain_ms=plain_ms,
                           bound_ms=work["bound_ms"],
                           bound_by=work["bound_by"], library_ms=lib_ms)
    return failures


def check_kernels(torch, bt, dev, csr, results):
    """Phase 3: bsr_dense and subpack at the shapes of bsr plans."""
    from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
    from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan
    pipe = bt.BsmrSddmm(csr, bt.SddmmConfig(alpha=0.3, delta=0.002,
                                            subpack_min_nnz=12))
    failures = []
    for k in (128, 32):
        A = torch.from_numpy(bt.make_dense(csr.rows, k, seed=1337)).to(dev)
        Bt = torch.from_numpy(
            bt.make_dense(k, csr.cols, seed=1338).T.copy()).to(dev)
        for fat in (32, 1):
            cfg = pipe.config.replace(k=k, dense_fat_group=fat)
            t0 = time.perf_counter()
            plan = bt.pack_tiles(csr, pipe.reorder(), cfg)
            dp = device_plan(plan, dev, emit="rphm")
            say(f"[kernels] banded_mesh_32k K={k} dense_fat_group={fat}: "
                f"G={plan.fat_group} T={plan.tile_panel.shape[0]} "
                f"(real {plan.num_tiles}) Tp={plan.sp_panel.shape[0]} "
                f"(real {plan.num_packed}) Tg={plan.g_panel.shape[0]} "
                f"E={plan.res_arow.shape[0]} host {time.perf_counter()-t0:.2f}s")
            A_panels = A.index_select(0, dp.row_perm_padded).reshape(
                plan.num_panels, plan.panel_height, k)
            label = f"G={plan.fat_group} K={k}"
            failures += check_case(
                torch, dk, results, "bsr_dense", label,
                (A_panels, Bt, dp.tile_panel, dp.tile_src),
                dict(fat_group=plan.fat_group, block_width=plan.block_width),
                keep=(k, fat) == (128, 32))
            if fat != 1 and plan.num_packed:
                failures += check_case(
                    torch, dk, results, "subpack", f"K={k}",
                    (A_panels, Bt, dp.sp_colperm, dp.sp_panel, dp.sp_sub),
                    dict(subblock_width=plan.subblock_width), keep=k == 128)
            del A_panels, dp
    return failures


def check_gathered_kernels(torch, bt, dev, csr, results):
    """Phase 3, second part: dense_tile, fused_gathered and subpack vs
    their plain versions at the shapes of banded_mesh_32k reorder plans
    (the kernels line keeps subpack's times on the bsr plan)."""
    from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
    from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan
    pipe = bt.BsmrSddmm(csr, bt.SddmmConfig(
        alpha=0.3, delta=0.05, subpack_min_nnz=12, col_mode="reorder",
        gathered_backend="fused"))
    failures = []
    for k in (128, 32):
        A = torch.from_numpy(bt.make_dense(csr.rows, k, seed=1337)).to(dev)
        Bt = torch.from_numpy(
            bt.make_dense(k, csr.cols, seed=1338).T.copy()).to(dev)
        t0 = time.perf_counter()
        plan = bt.pack_tiles(csr, pipe.reorder(), pipe.config.replace(k=k))
        dp = device_plan(plan, dev, emit="rphm")
        say(f"[kernels] banded_mesh_32k reorder K={k} alpha=0.3 delta=0.05: "
            f"T={plan.tile_panel.shape[0]} (real {plan.num_tiles}) "
            f"Tp={plan.sp_panel.shape[0]} (real {plan.num_packed}) "
            f"Tg={plan.g_panel.shape[0]} (real {plan.num_gathered}) "
            f"E={plan.res_arow.shape[0]} host "
            f"{time.perf_counter() - t0:.2f}s")
        A_panels = A.index_select(0, dp.row_perm_padded).reshape(
            plan.num_panels, plan.panel_height, k)
        for name, ids in (("dense_tile", (dp.tile_panel, dp.tile_src)),
                          ("fused_gathered", (dp.g_panel, dp.g_cols))):
            failures += check_case(torch, dk, results, name, f"K={k}",
                                   (A_panels, Bt) + ids, {}, keep=k == 128)
        failures += check_case(
            torch, dk, results, "subpack", f"reorder K={k}",
            (A_panels, Bt, dp.sp_colperm, dp.sp_panel, dp.sp_sub),
            dict(subblock_width=plan.subblock_width), keep=False)
        del A_panels, dp
    return failures


def zero_launches():
    from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
    for kname in KERNELS:
        getattr(dk, kname).launches = 0


def read_launches(results):
    """The counters since zero_launches(), added to the kernels line."""
    from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
    launches = {kname: getattr(dk, kname).launches for kname in KERNELS}
    for kname, n in launches.items():
        results[kname]["launches"] += n
    return launches


def plan_kernels(log):
    """The hand kernels a bsr-mode run's plan needs, from its RunLog."""
    return (("bsr_dense",) if log.num_dense_blocks else ()) + \
        (("subpack",) if log.num_packed_blocks else ())


def main_path(bt, dev, suite, results, picks):
    """Phase 4: the user's entry point on the suite matrices. The arm and
    sddmm_ms of each matrix's fp32 bsr run go into ``picks``."""
    from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
    failures = []
    for name, alpha, delta, od, mode, gb, tiers, expect in MAIN:
        csr = suite[name]
        cfg = bt.SddmmConfig(k=128, alpha=alpha, delta=delta,
                             subpack_min_nnz=12, out_dtype=od,
                             col_mode=mode, gathered_backend=gb)
        A = bt.make_dense(csr.rows, 128, seed=1337)
        B = bt.make_dense(128, csr.cols, seed=1338)
        zero_launches()
        t0 = time.perf_counter()
        pipe = bt.BsmrSddmm(csr, cfg, device=dev)
        log = pipe.benchmark(A, B, validate=True, tier_times=tiers,
                             file=name)
        wall = time.perf_counter() - t0
        launches = read_launches(results)
        if (mode, gb, od) == ("bsr", "xla", "float32"):
            picks[name] = {"fixed arm": (alpha, delta, 12, log.sddmm_ms)}
        tier_split = "".join(
            f"; {key} {val}" for key, val in log.extras.items()
            if key.startswith("tier_"))
        say(f"[main] {name} K=128 {mode} gathered={gb} alpha={alpha} "
            f"delta={delta} {od}: "
            f"check {log.check_result} (error rate {log.error_rate}); "
            f"sddmm_ms {log.sddmm_ms:.4f} ({log.gflops:.1f} GFLOPS), "
            f"sddmm_csr_ms {log.extras['sddmm_csr_ms']} "
            f"({log.extras['gflops_csr']} GFLOPS); "
            f"M=N={csr.rows} nnz={csr.nnz} G={log.extras['fat_group']} "
            f"tiles dense {log.num_dense_blocks} packed "
            f"{log.num_packed_blocks} gathered {log.num_gathered_blocks} "
            f"residual nnz {log.residual_nnz}; reorder "
            f"{log.row_reordering_ms:.0f} ms, pack {log.pack_ms:.0f} ms, "
            f"wall {wall:.1f} s; launches {launches}; "
            f"device {log.device}{tier_split}")
        run = f"{name} {mode} {gb} {od}"
        if log.check_result != "pass":
            failures.append(f"{run}: check {log.check_result}")
        if tiers and "tier_dense_ms" not in log.extras:
            failures.append(f"{run}: no tier times")
        for kname in expect:
            if launches[kname] <= 0:
                failures.append(f"{run}: {kname} never launched")
        # one call of the body, through the same pipeline (its reordering
        # is kept); counted apart from the benchmark's launches above
        zero_launches()
        pipe.run(A, B)
        per_call = {kname: getattr(dk, kname).launches for kname in KERNELS}
        say(f"[main]   launches per call: {per_call}")
        for kname, n in per_call.items():
            rec = results[kname]
            rec["launches_per_call"] = max(rec["launches_per_call"], n)
            if kname in expect and n != 1:
                failures.append(f"{run}: {kname} launched {n} times in one "
                                f"call")
    return failures


PROFILE = (("bsr", dict(alpha=0.3, delta=0.002)),
           ("reorder", dict(alpha=0.3, delta=0.05, col_mode="reorder",
                            gathered_backend="fused")))
PROFILE_CALLS = 20


def profile_phase(torch, bt, dev, csr):
    """torch.profiler over PROFILE_CALLS calls of the rphm body on
    banded_mesh_32k at K=128, bsr and reorder: device busy time, host
    enqueue time and each device kernel's share per call. Reports; fails
    only if the body does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan, make_sddmm_body
    A = torch.from_numpy(bt.make_dense(csr.rows, 128, seed=1337)).to(dev)
    Bt = torch.from_numpy(
        bt.make_dense(128, csr.cols, seed=1338).T.copy()).to(dev)
    for mode, arm in PROFILE:
        cfg = bt.SddmmConfig(k=128, subpack_min_nnz=12, **arm)
        plan = bt.pack_tiles(csr, bt.BsmrSddmm(csr, cfg).reorder(), cfg)
        dp = device_plan(plan, dev, emit="rphm")
        body = make_sddmm_body(plan, cfg, emit="rphm")
        for _ in range(PROFILE_CALLS):
            body(A, Bt, dp)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_CALLS):
                body(A, Bt, dp)
            enqueue = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device kernels only: an aten op's row repeats its kernels' time
        rows = [(e.key, getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows = sorted(((key, us / PROFILE_CALLS / 1e3) for key, us in rows
                       if us > 0), key=lambda kv: -kv[1])
        busy = sum(ms for _, ms in rows)
        if not busy:
            say(f"[profile] banded_mesh_32k {mode}: no device time in the "
                f"trace: not measured")
            continue
        say(f"[profile] banded_mesh_32k K=128 {mode} {arm}, per call over "
            f"{PROFILE_CALLS} calls (profiler on): wall "
            f"{wall * 1e3 / PROFILE_CALLS:.4f} ms, host enqueue "
            f"{enqueue * 1e3 / PROFILE_CALLS:.4f} ms, device busy "
            f"{busy:.4f} ms")
        for key, ms in rows[:10]:
            say(f"[profile]   {ms:.4f} ms {ms / busy:5.1%}  {key[:100]}")
        gathers = sum(e.count for e in prof.key_averages()
                      if e.key == "aten::index_select") / PROFILE_CALLS
        say(f"[profile]   index_select calls per call: {gathers:g}; with "
            f"Bt[sp_colperm] materialised before subpack instead of read "
            f"inside it: {gathers + bool(plan.num_packed):g}")
    return []


CLI_RUNS = ((["-a", "0.3", "-d", "0.002", "--validate"], ()),
            (["-a", "0.3", "-d", "0.05", "--col-mode", "reorder",
              "--evaluate", "--tier-times", "--reorder-cache", "--validate"],
             ("[denseBlockGain", "[tier_dense_ms",
              "[tier_overlap_efficiency")),
            (["--auto-alpha", "--refine-top", "3", "--validate", "-l",
              "{logs}"], ("[alpha", "[delta")))
AUTO_LOG = "BSMR_k_128_a_auto_d_auto.log"


def run_cli(bt, csr) -> list:
    """Phase 8: the console entry point on a suite matrix in a .mtx."""
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "community_20k.mtx")
        bt.formats.save_mtx(path, csr)
        env = dict(os.environ, BSMR_CACHE_DIR=os.path.join(tmp, "cache"))
        logs = os.path.join(tmp, "logs")
        for flags, want in CLI_RUNS:
            flags = [f.format(logs=logs) for f in flags]
            cmd = [sys.executable, "-m", f"{PKG}.cli", "-f", path, "-k",
                   "128", *flags]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                                  text=True, timeout=600)
            say(f"[cli] -k 128 {' '.join(flags)}: exit {proc.returncode} in "
                f"{time.perf_counter() - t0:.1f} s")
            for line in proc.stdout.splitlines():
                if line.startswith(("[checkResults", "[bsmr_sddmm ",
                                    "[device", "[tier_") + want):
                    say(f"[cli]   {line}")
            if (proc.returncode != 0
                    or "[checkResults : pass]" not in proc.stdout
                    or not all(w in proc.stdout for w in want)):
                failures.append(f"cli {' '.join(flags)}: exit "
                                f"{proc.returncode}: {proc.stderr[-2000:]}")
        cache = env["BSMR_CACHE_DIR"]
        cached = os.listdir(cache) if os.path.isdir(cache) else []
        say(f"[cli] reorder cache entries: {cached}")
        if not any(f.endswith(".npz") for f in cached):
            failures.append("cli --reorder-cache wrote no cache entry")
        written = os.listdir(logs) if os.path.isdir(logs) else []
        say(f"[cli] logs: {written}")
        if AUTO_LOG not in written:
            failures.append(f"cli --auto-alpha wrote no {AUTO_LOG}")
    return failures


AUTOTUNE = ("banded_mesh_32k", "community_20k")


def run_arm(bt, pipe, results, name, tag, **kw):
    """pipe.benchmark(validate=True, **kw) at K=128 with the counters set
    to 0 just before it and read just after: (log, failures)."""
    csr = pipe.csr
    A = bt.make_dense(csr.rows, 128, seed=1337)
    B = bt.make_dense(128, csr.cols, seed=1338)
    zero_launches()
    t0 = time.perf_counter()
    log = pipe.benchmark(A, B, validate=True, file=name, **kw)
    wall = time.perf_counter() - t0
    launches = read_launches(results)
    say(f"[{tag}] {name} benchmark({', '.join(f'{k}={v}' for k, v in kw.items())}"
        f"): alpha={log.alpha} delta={log.delta} subpack="
        f"{'auto' if kw.get('delta') == 'auto' else pipe.config.subpack_min_nnz} "
        f"{log.extras.get('strategy', 'tiled')}: check {log.check_result}; "
        f"sddmm_ms {log.sddmm_ms:.4f} ({log.gflops:.1f} GFLOPS); tiles dense "
        f"{log.num_dense_blocks} packed {log.num_packed_blocks} gathered "
        f"{log.num_gathered_blocks} residual nnz {log.residual_nnz}; wall "
        f"{wall:.1f} s; launches {launches}")
    failures = []
    if log.check_result != "pass":
        failures.append(f"{tag} {name} {kw}: check {log.check_result}")
    for kname in plan_kernels(log):
        if launches[kname] <= 0:
            failures.append(f"{tag} {name} {kw}: {kname} never launched")
    return log, failures


def run_pick(bt, dev, csr, results, name, tag, alpha, delta, subpack,
             use_dense):
    """Benchmark a picked arm as a fixed arm (no second pricing)."""
    pipe = bt.BsmrSddmm(csr, bt.SddmmConfig(k=128, subpack_min_nnz=subpack),
                        device=dev)
    if use_dense:
        return run_arm(bt, pipe, results, name, tag, delta="dense")
    return run_arm(bt, pipe, results, name, tag, alpha=alpha, delta=delta)


def estimate_pick(choice):
    """The pick of a ConfigChoice's estimates alone: its table holds every
    arm's estimate beside the refine's ("measured", ...) times, so this is
    what choose() without refine_top returns. ((alpha, delta, subpack),
    estimate ms, use_dense)."""
    arms = {key: ms for key, ms in choice.candidates.items()
            if isinstance(key, tuple) and key[0] != "measured"}
    key = min(arms, key=arms.get)
    return key, arms[key], choice.candidates.get("dense", math.inf) < arms[key]


def autotune_phase(bt, dev, suite, results, picks):
    """Phase 5: the autotuner's picks on the card, priced with V5E_COSTS
    and measured (refine_top=4), each run by benchmark(validate=True).
    Fills picks[matrix] with each pick's label and sddmm_ms."""
    from bsmr_sddmm_tpu_torch import autotune
    if autotune.current_costs() is not autotune.V5E_COSTS:
        return ["autotune: the cost table in effect is not V5E_COSTS"]
    failures = []
    for name in AUTOTUNE:
        csr = suite[name]
        cfg = bt.SddmmConfig(k=128, subpack_min_nnz=12)
        pipe = bt.BsmrSddmm(csr, cfg, device=dev)
        t0 = time.perf_counter()
        ref = pipe.choose(alpha="auto", refine_top=4)
        wall = time.perf_counter() - t0
        (alpha, delta, sub), est_ms, use_dense = estimate_pick(ref)
        say(f"[autotune] {name} K=128 V5E_COSTS pick: alpha={alpha} "
            f"delta={delta} subpack={sub} estimate {est_ms:.4f} ms (dense "
            f"arm {ref.candidates['dense']:.4f} ms, use_dense={use_dense})")
        log, found = run_pick(bt, dev, csr, results, name, "autotune",
                              alpha, delta, sub, use_dense)
        failures += found
        picks[name]["V5E_COSTS pick"] = (alpha, delta, sub, log.sddmm_ms)
        measured = {key[1:]: ms for key, ms in ref.candidates.items()
                    if isinstance(key, tuple) and key[0] == "measured"}
        for key, ms in sorted(measured.items(), key=lambda kv: kv[1]):
            say(f"[autotune]   measured (alpha, delta, subpack)={key}: "
                f"{ms:.4f} ms (estimate {ref.candidates[key]:.4f} ms)")
        say(f"[autotune] {name} measured pick: alpha={ref.alpha} "
            f"delta={ref.delta} subpack={ref.subpack} "
            f"{ref.estimated_ms:.4f} ms, use_dense={ref.use_dense}; "
            f"{len(ref.candidates) - len(measured)} arms priced and "
            f"{len(measured)} re-timed in {wall:.1f} s")
        if len(measured) < 2:
            failures.append(f"{name}: {len(measured)} measured candidates")
        # the user's call: benchmark() runs its own measured choice
        pipe.config = cfg.replace(autotune_refine_top=4)
        log, found = run_arm(bt, pipe, results, name, "autotune",
                             alpha="auto", delta="auto")
        failures += found
        picks[name]["measured pick (auto)"] = (log.alpha, log.delta, "-",
                                               log.sddmm_ms)
    return failures


#: calibrate()'s tiers in the order it times them, and the line each fits
CALIBRATED_TIERS = (("dense", "dense_floor"), ("packed", "packed"),
                    ("gathered", "gathered"), ("residual", "pernnz"))
#: the tiers whose bytes grow with K: the fitted slope must be above 0
#: (the per-nnz residual is descriptor-bound, V5E_COSTS' own slope is 0)
BYTE_BOUND = ("dense_floor", "packed", "gathered")
#: a point timed twice in one run must agree to this (relative): a lone
#: tier timed per call by CUDA events reads the host's enqueue instead and
#: spreads 2x; a replayed graph repeats within a few percent
REPEAT_RTOL = 0.10
#: the fitted table must price each point to this (relative). A line fitted
#: to two points passes through them; only a clamp moves it, and the dense
#: floor's base clamp (below) moves its K=32 point by 6-8% on an H100
FIT_RTOL = 0.15


def check_fit(autotune, costs, points):
    """Hold calibrate()'s table to the points it was fitted to: (k, units,
    fat group, ms, repeat ms) per tier and K, in calibrate()'s order."""
    failures, per_unit = [], {}
    v5e = autotune.V5E_COSTS
    ks = autotune.CALIBRATION_KS
    tiers = [t for t in CALIBRATED_TIERS for _ in ks]

    def step_ns(k, G):
        return (v5e["dense_step_base_ns"] + v5e["dense_step_k_ns"] * k) / G

    # calibrate() fits the dense floor to max(per tile - step, 0.5)
    for (tier, _), (k, units, G, ms, _) in zip(tiers, points):
        if tier == "dense":
            per_unit[k] = ms * 1e6 / max(units, 1) - step_ns(k, G)
    # a tile cheaper than v5e's step model at every K leaves no line to fit
    dense_clamped = bool(per_unit) and all(v <= 0.5
                                           for v in per_unit.values())
    for (tier, prefix), (k, units, G, ms, again) in zip(tiers, points):
        per = ms * 1e6 / max(units, 1)
        model = costs[f"{prefix}_base_ns"] + costs[f"{prefix}_k_ns"] * k
        if tier == "dense":     # calibrate() fits per tile less the step
            model += step_ns(k, G)
        err, spread = abs(model - per) / per, abs(again - ms) / ms
        say(f"[calibrate]   {tier} K={k}: {units} units in {ms:.4f} ms = "
            f"{per:.3f} ns per unit (repeat {again:.4f} ms, "
            f"{spread:.1%}); the fitted table prices it {model:.3f} ns "
            f"({err:.1%})")
        if spread > REPEAT_RTOL:
            failures.append(f"calibrate: {tier} K={k} repeats {ms:.4f} vs "
                            f"{again:.4f} ms")
        if not err <= FIT_RTOL and not (tier == "dense" and dense_clamped):
            failures.append(f"calibrate: {tier} K={k} priced {model:.3f} "
                            f"ns against {per:.3f} measured")
    bad = [key for key in autotune.CALIBRATED_KEYS
           if not math.isfinite(costs[key])]
    flat = [p for p in BYTE_BOUND if not costs[f"{p}_k_ns"] > 0
            and not (p == "dense_floor" and dense_clamped)]
    if bad:
        failures.append(f"calibrate: non-finite constants {bad}")
    if flat:
        failures.append(f"calibrate: per-unit time does not rise with K "
                        f"for {flat}")
    clamped = [p for _, p in CALIBRATED_TIERS if costs[f"{p}_base_ns"] == 0.5]
    say(f"[calibrate] bases clamped at 0.5: {clamped or 'none'}")
    if dense_clamped:
        say(f"[calibrate]   dense_floor: both points clamp: per tile less "
            f"the v5e step model (108 + 0.79 K)/G is "
            f"{ {k: round(v, 3) for k, v in per_unit.items()} } ns, at or "
            f"under the 0.5 ns floor calibrate() keeps, so the fitted line "
            f"is flat at 0.5 ns and is held neither to its points nor to a "
            f"positive slope; the card's tiles cost less than the TPU step "
            f"model that calibrate() subtracts (kept for parity with the "
            f"JAX package)")
    elif "dense_floor" in clamped:
        import numpy as np
        slope, base = np.polyfit(list(per_unit), list(per_unit.values()), 1)
        say(f"[calibrate]   dense_floor: the fit's base is {base:.3f} ns "
            f"(slope {slope:.4f}); known artifact of the v5e step model "
            f"(108 + 0.79 K)/G that calibrate() subtracts from the card's "
            f"per-tile time, kept for parity with the JAX package")
    return failures


def calibrate_phase(torch, bt, dev, suite, smi, results, picks):
    """Phase 6: calibrate() on the card, its table next to V5E_COSTS and
    held to its points, and the suite matrices re-priced with it and run.
    The per-tier timer is wrapped to time each point twice and keep the
    points each line is fitted to. Leaves no table in effect after it."""
    from bsmr_sddmm_tpu_torch import autotune
    points = []
    time_tier = autotune._time_tier

    def recorded(body, A, Bt, dplan):
        ms = time_tier(body, A, Bt, dplan)
        group = dplan.tile_panel.shape[0] // max(dplan.tile_src.shape[0], 1)
        points.append((A.shape[1], body(A, Bt, dplan).shape[0], group, ms,
                       time_tier(body, A, Bt, dplan)))
        return ms

    old = os.environ["BSMR_CACHE_DIR"]
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["BSMR_CACHE_DIR"] = tmp
        autotune._time_tier = recorded
        try:
            zero_launches()
            t0 = time.perf_counter()
            costs = autotune.calibrate()
            wall = time.perf_counter() - t0
            launches = read_launches(results)
            path = autotune._cache_path(torch.cuda.get_device_name())
            stored = os.path.exists(path)
        finally:
            autotune._time_tier = time_tier
            os.environ["BSMR_CACHE_DIR"] = old
    say(f"[calibrate] calibrate() in {wall:.1f} s (each point timed twice); "
        f"launches {launches}; cache {os.path.basename(path)} "
        f"{'written' if stored else 'MISSING'}")
    failures = check_fit(autotune, costs, points)
    say(f"[calibrate] {smi}")
    say(f"[calibrate]   {'key':20s} {'V5E_COSTS (TPU v5e)':>20s} "
        f"{'calibrated here':>16s}")
    for key in autotune.CALIBRATED_KEYS:
        say(f"[calibrate]   {key:20s} {autotune.V5E_COSTS[key]:20.4f} "
            f"{costs[key]:16.4f}")
    if not stored:
        failures.append(f"calibrate: no cache file {path}")
    for kname in ("bsr_dense", "subpack"):
        if launches[kname] <= 0:
            failures.append(f"calibrate: {kname} never launched")
    try:
        for name in AUTOTUNE:
            t0 = time.perf_counter()
            c = bt.BsmrSddmm(suite[name], bt.SddmmConfig(
                k=128, subpack_min_nnz=12), device=dev).choose(alpha="auto")
            say(f"[calibrate] {name} calibrated pick: alpha={c.alpha} "
                f"delta={c.delta} subpack={c.subpack} estimate "
                f"{c.estimated_ms:.4f} ms, use_dense={c.use_dense}; priced "
                f"in {time.perf_counter() - t0:.1f} s")
            log, found = run_pick(bt, dev, suite[name], results, name,
                                  "calibrate", c.alpha, c.delta, c.subpack,
                                  c.use_dense)
            failures += found
            picks[name]["calibrated pick"] = (c.alpha, c.delta, c.subpack,
                                              log.sddmm_ms)
            for label, (alpha, delta, sub, ms) in picks[name].items():
                say(f"[picks] {name} K=128 {label}: alpha={alpha} "
                    f"delta={delta} subpack={sub} sddmm_ms {ms:.4f}")
    finally:
        # later phases price with V5E_COSTS, as their lines say
        autotune._CALIBRATED = None
    return failures


def dense_phase(bt, dev, results):
    """Phase 7: the dense fallback against the best-priced tiled plan on a
    uniform mask, and the cost model's choice there and on a blocky mask,
    both priced with V5E_COSTS."""
    from bsmr_sddmm_tpu_torch import autotune, datasets
    from bsmr_sddmm_tpu_torch.formats import random_mask
    if autotune.current_costs() is not autotune.V5E_COSTS:
        return ["dense: the cost table in effect is not V5E_COSTS"]
    uni = datasets.uniform(4096, 350_000, seed=9)
    cfg = bt.SddmmConfig(k=128, subpack_min_nnz=12)
    pipe = bt.BsmrSddmm(uni, cfg, device=dev)
    choice = pipe.choose()
    tiled = {key: ms for key, ms in choice.candidates.items()
             if key != "dense"}
    delta, sub = min(tiled, key=tiled.get)
    say(f"[dense] uniform(4096, 350000) K=128, priced with V5E_COSTS: "
        f"use_dense={choice.use_dense}: dense arm "
        f"{choice.candidates['dense']:.4f} ms vs best tiled (delta={delta}, "
        f"subpack={sub}) {tiled[delta, sub]:.4f} ms, estimated")
    _, failures = run_arm(bt, pipe, results, "uniform_4096", "dense",
                          delta="dense")
    pipe.config = cfg.replace(subpack_min_nnz=sub)
    _, found = run_arm(bt, pipe, results, "uniform_4096", "dense",
                       delta=delta)
    blocky = random_mask(rows=16384, cols=16384, nnz=300_000, seed=3,
                         block_rows=32, block_cols=256)
    c2 = bt.BsmrSddmm(blocky, cfg, device=dev).choose()
    tiled = min(v for key, v in c2.candidates.items() if key != "dense")
    say(f"[dense] blocky random_mask(16384, 16384, 300000) K=128, priced "
        f"with V5E_COSTS: use_dense={c2.use_dense}: dense arm "
        f"{c2.candidates['dense']:.4f} ms vs best tiled (delta={c2.delta}) "
        f"{tiled:.4f} ms, estimated")
    return failures + found


def timed(phase, fn, *args) -> list:
    """Run one phase, print its wall time, return its failures."""
    t0 = time.perf_counter()
    found = fn(*args)
    say(f"[{phase}] phase wall {time.perf_counter() - t0:.1f} s"
        f"{'; FAILED: ' + str(found) if found else ''}")
    return found


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA "
             "device")
    bt = import_port()
    from bsmr_sddmm_tpu_torch import datasets
    from bsmr_sddmm_tpu_torch.ops import _build
    # the plain versions are the reference: full fp32 matmuls, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say(f"[device] {kind}; count {torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    say(f"[device] nvidia-smi: {smi}")

    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info
    say(f"[build] {info['path']}: compiled={info['compiled']} nvcc "
        f"{info['seconds']:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    report = info.get("report", "")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    smem = [int(b) for b in re.findall(r"(\d+) bytes smem", report)]
    if regs:
        spills = re.search(r"[1-9]\d* bytes spill", report)
        say(f"[build] ptxas: {len(regs)} kernel instances, "
            f"{min(regs)}-{max(regs)} registers, up to {max(smem)} bytes "
            f"static smem, spills: {'YES' if spills else 'none'}")
        # per kernel: registers and spill bytes over its instances (the
        # tensor-core kernels take their shared memory at launch: 23-198 KB)
        per_kernel = {}
        for fn, st, ld, r in re.findall(
                r"Compiling entry function '(\w+)' for[^\n]*\n[^\n]*\n"
                r"[^\n]*?(\d+) bytes spill stores, (\d+) bytes spill loads"
                r"\n[^\n]*Used (\d+) registers", report):
            kname = re.search(r"\d+([a-z_]+_kernel)", fn)
            per_kernel.setdefault(kname.group(1) if kname else fn,
                                  []).append((int(r), int(st) + int(ld)))
        for kname, vals in sorted(per_kernel.items()):
            say(f"[build]   {kname}: {len(vals)} instances, "
                f"{min(v[0] for v in vals)}-{max(v[0] for v in vals)} "
                f"registers, spill bytes {max(v[1] for v in vals)}")

    t0 = time.perf_counter()
    suite = {name: gen() for name, gen in datasets.SUITE
             if name in ("banded_mesh_32k", "community_20k")}
    say(f"[data] suite matrices in {time.perf_counter() - t0:.1f} s")

    results = {name: dict(name=name, route="cuda", **meta, launches=0,
                          launches_per_call=0, max_abs_err=0.0, ms=None,
                          plain_ms=None, bound_ms=None, bound_by=None,
                          library_ms=None)
               for name, meta in KERNELS.items()}
    dev = torch.device("cuda")
    failures = check_kernels(torch, bt, dev, suite["banded_mesh_32k"],
                             results)
    failures += check_gathered_kernels(torch, bt, dev,
                                       suite["banded_mesh_32k"], results)
    if failures:
        fail(f"kernels disagree with their plain versions: {failures}")
    picks = {}
    failures = main_path(bt, dev, suite, results, picks)
    if failures:
        fail(f"main path: {failures}")
    timed("profile", profile_phase, torch, bt, dev, suite["banded_mesh_32k"])
    failures = timed("autotune", autotune_phase, bt, dev, suite, results,
                     picks)
    failures += timed("calibrate", calibrate_phase, torch, bt, dev, suite,
                      smi, results, picks)
    failures += timed("dense", dense_phase, bt, dev, results)
    failures += timed("cli", run_cli, bt, suite["community_20k"])
    if failures:
        fail(f"{failures}")
    if "jax" in sys.modules:
        fail("jax was imported")

    say(smi)
    say(json.dumps({"kernels": list(results.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # an empty cache directory for the whole run: each phase prices with
    # the table it names, never a tier_costs file left in build/
    with tempfile.TemporaryDirectory() as cache:
        os.environ["BSMR_CACHE_DIR"] = cache
        sys.exit(main())
