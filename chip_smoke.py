#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bsmr_sddmm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card. Phases:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc compiles csrc/*.cu for sm_90a (into build/torch_kernels/,
   set by utils.compilecache.enable_compile_cache; a later run of the same
   sources in the same checkout loads that library, and says so);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes of plans packed from the SUITE matrix banded_mesh_32k at
   K=128 and K=32 (fp32 and fp16 output), at three TF32 passes and at one
   (matmul_precision="default"; there the library call is torch.bmm with
   TF32 allowed), with max errors; the kernel's
   time (a replayed CUDA graph, twice, in turns with the others) beside
   its bound (dense_kernels.tile_work: the least time an H100 could take
   for this launch's bytes and operations), its share of the bound, the
   time of one library call (torch.bmm in fp32 on operands gathered
   before the timed window) and the plain version's: bsr_dense and subpack
   on bsr plans (the plan's fat group G and G=1), bsr_dense alone at K=64
   (resident route) and K=256 (streaming route) on the fat plan, dense_tile,
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
   banded_mesh_32k (at tier_serialize "off", whose eager calls fork as a
   replay of "auto" does) gives device busy time, host enqueue time, each
   device kernel's share and the index_select calls per call ([profile]).
   benchmark() times a replayed CUDA graph of one call (sddmm_ms), printed
   beside the eager calls' time (sddmm_eager_ms, host enqueue included);
   the banded bsr run's sddmm_ms must read within HEADLINE_RTOL of
   [profile]'s device busy for that body (the union of its kernels'
   intervals, printed beside their sum: the tiers overlap on two streams).
   Then the settings runs ([main settings]): both fp32 bsr cells with
   tier_serialize "on" (one stream) and "off" (the gathered tier and the
   residual on a side stream), and with matmul_precision="default" (one
   TF32 pass), each validated and printing sddmm_ms and sddmm_eager_ms;
   the rphm outputs of "on" and "off" must be bit-equal, and so must those
   of a "bf16x3" body called with torch.backends.cuda.matmul.allow_tf32 =
   True and with False. Each cell's body at "on", "off" and "auto" is
   then timed in turns (replayed, eager, host enqueue; medians), and so
   is banded_mesh_64k at K=256, where "auto" serializes; the arms must
   agree bit for bit, and each must fork the calls it should ("off"
   every call, "auto" the captured ones where it lets the tiers overlap);
5. autotune: on banded_mesh_32k and community_20k at K=128, subpack 12,
   BsmrSddmm.choose(alpha="auto", refine_top=4) priced with V5E_COSTS: the
   pick of its estimates, each candidate's measured ms and the measured
   pick; then benchmark(alpha="auto", delta="auto", validate=True), each
   pick's sddmm_ms beside the fixed arm's of phase 4;
6. calibrate: autotune.calibrate() on the card (BSMR_CACHE_DIR in a
   temporary directory), each point timed twice, the table held to its
   points (the byte-bound tiers' slopes above 0) and printed key by key
   next to V5E_COSTS, and both matrices re-priced with it;
7. arms: the arm-selection tools (bsmr_sddmm_tpu_torch.tools) on
   bench.suite.run(full_grid=True) at K=128 on banded_mesh_32k and
   community_20k (24 fp32 arms and an fp16 sibling each, the first arm of
   each matrix validated): check_autotune on the arms that bench.suite
   recorded (run(records=...)), the positional parse of the echoed lines
   held to them, and the V5E_COSTS host pick as a fraction of the sweep
   best, a pick outside the swept grid timed on the card
   (time_outside_grid), so that every row has one; audit_cost_model's
   measured / estimated geomean per matrix and subpack;
   fit_costs_from_audit on the subpack-0 rows, its table
   beside V5E_COSTS and its quality, written to the card's cost cache,
   read back by current_costs() and the pick checked again under it;
   probe_refine_pick's host and refined picks on community_20k (alpha
   0.1 and 0.3);
   profile_tiers on banded_mesh_32k;
8. dense: the dense fallback (delta="dense") and the best tiled plan
   priced with V5E_COSTS, at its (delta, subpack), on
   datasets.uniform(4096, 350_000) at K=128 with validate=True, and the
   cost model's choice there and on a blocky mask;
9. CLI: python -m bsmr_sddmm_tpu_torch.cli -f <suite matrix .mtx> -k 128
   -a 0.3 -d 0.002 --validate exits 0, and so do the run with
   --col-mode reorder -d 0.05 --evaluate --tier-times --reorder-cache
   (BSMR_CACHE_DIR in a temporary directory) and the run with --auto-alpha
   --refine-top 3, which writes the BSMR_k_128_a_auto_d_auto log;
10. train: the sparse transformer (seq_len 2048, vocab 64, head_dim 128, 2
   heads, 1 layer, window 128, stride 64, SddmmConfig(k=128, delta=0.05))
   through the hand kernels: logits and every parameter's gradient against
   the same net built on the plain versions (backend="torch"), three Adam
   steps whose last loss is below the first, ms per step (CUDA events after
   a warm-up step) and one step's torch.profiler split (hand kernels, the
   rest of the SDDMM body, backward SpMMs, the rest); then the graph
   transformer on community_20k (20000 nodes, features 16, head_dim 128,
   4 heads, 2 layers, 8 classes; SddmmConfig(k=128, alpha=0.1,
   delta=0.002, subpack_min_nnz=12)): logits and gradients against the
   plain build; one head's output and its q, k, v gradients against the
   CSR oracles of ops.graph under autograd, which share no code with the
   tile layout; one Adam step at GRAPH_SMALL_LR that must lower the loss
   from the same weights (put back after it); then train steps at the
   default lr with a finite loss and their profile split, and the step
   at tier_serialize "auto" and "off" timed in turns;
11. batched: make_batched_sddmm_fn at Z=4 on the community_20k plan, K=128,
   against four single calls of the body;
12. sharded: the parallel layer's sharded SDDMM over a 4-shard mesh (4
   cards where 4 are visible, else 4 shards on cuda:0, run one after
   another) at K=128: banded_mesh_32k at its R4_BEST arm (alpha 0.3, delta
   0.002, subpack 12) with emit="csr" (B replicated, then b-sharded) and
   emit="rphm" reassembled through sharded_rphm_to_csr, then the
   single-device body's emit="csr_scatter"; community_20k (alpha 0.1) with
   the fused gathered tier. Each against the fp64 oracle, the same path
   built on the plain kernel versions (backend="torch") and the
   single-device port's output, with its launches (each tile kernel once
   per shard), all-gathers (0, or 1 b-sharded) and ms per call by CUDA
   events beside the single-device body's;
13. ring: make_ring_sddmm(emit="csr") on both matrices over 4 shards:
   check_data, agreement with its plain build and the single-device
   output, bsr_dense 16 launches a call (dense_tile 16 where the plan
   has gathered tiles), 3 hops per shard, no all-gather, ms per call;
14. weak: parallel.distributed.sddmm_weak_scaling([1, 2, 4]) at its
   defaults: shapes, output slots per shard, no collective, ms per call
   (with the shards on one card: serial work, not a scaling figure);
15. multihost: two worker processes (python -m
   bsmr_sddmm_tpu_torch.parallel.worker) with 2 shards each on cuda:0 over
   gloo (host-staged), banded_mesh_32k at K=128: the b-sharded all-gather
   and the ring's hops cross the process boundary; both check pass, one
   plan hash; over nccl with a card per process where 2 cards are visible
   (else printed as not run);
16. train-sharded: both model families' Adam step over a 4-shard mesh
   (models.*.make_forward(..., mesh=)) at full width: the graph
   transformer of phase 10 on community_20k (at the worker's TRAIN_LR,
   1e-5) and its sparse transformer. Logits and every gradient against
   the same step built on the plain versions (backend="torch") and
   against the single-device kernel step; bsr_dense and subpack launched
   once per shard, head and layer of every forward; three Adam steps that
   lower the loss, ms a step (CUDA events, steps 2-3) beside the
   single-device step's in the same phase, and one step's torch.profiler
   split; then two parallel.worker --train processes on cuda:0 over gloo
   with one parameter hash, whose losses equal the one-process steps';
17. graft: the graft entry points (bsmr_sddmm_tpu_torch.graft_entry,
   the port of __graft_entry__.py): entry()'s forward (the graph
   transformer on the tiny packed mask), dryrun_multichip(8) on its tiny
   problem with the 8 shards on the visible cards (all on cuda:0 on a
   one-card machine), and dryrun_multichip(4) at full width on
   community_20k at [train-sharded]'s arm (head_dim 128). Each against the
   same path built on the plain versions at TOL (logits; the loss and
   every SDDMM output, each held to the fp64 oracle inside the dry run),
   with the launches of bsr_dense and subpack (and, in the dry runs'
   ring, dense_tile), ms a call and wall time beside the card's name and
   power limit;
18. bench: bench.suite.run on banded_mesh_32k and community_20k at K 128
   and 256 with bench.py's R4_BEST arms (4 cells and an fp16 sibling,
   each validated), bsr_dense's launches and route at each K, the per-K
   geomean; then bench.runner.run_suite on community_20k saved as .mtx
   (the CLI and the gather_dot baseline, each in a process of its own on
   the card) read back by bench.analyze into a one-row results CSV.

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
# few fp32 ulps of the sum, not bit for bit. At one pass the plain version
# multiplies the operands rounded to TF32, whose products the MMA computes
# exactly: again only the order of summation differs.
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


def launch_work(torch, dk, name, args, kw, out_dtype, passes):
    """dense_kernels.tile_work of one launch at ``passes`` TF32 passes:
    every operand row it references counted once, the index arrays once,
    the output once. ``args`` are the wrapper's: (A_panels, B, ..., panel
    ids, B ids)."""
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
                        b_rows=b_rows, index_bytes=index_bytes,
                        passes=passes)


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
    """One kernel at one plan's shapes, fp32 and fp16 output, at three TF32
    passes and at one: against its plain version at the same pass count,
    and timed (fp16 at three passes only) beside its bound, the library
    call and the plain version. The library call is ``torch.bmm`` in fp32
    at three passes and with TF32 allowed (the library's one pass) at one.
    ``keep``: these are the times of the kernels line (the one-pass ones
    under ``one_pass``)."""
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda, time_cuda_graph
    kern, plain = getattr(dk, name), getattr(dk, f"{name}_plain")
    failures = []
    a, b = library_operands(torch, name, args, kw)

    def library(passes):
        with dk.tf32_matmuls(passes == 1):
            return torch.bmm(a, b.mT)

    for passes in (3, 1):
        for od in ("float32", "float16"):
            dt = getattr(torch, od)
            kwp = dict(kw, out_dtype=dt, passes=passes)
            got = kern(*args, **kwp)
            want = plain(*args, **kwp)
            torch.cuda.synchronize()
            max_abs, max_rel, ok = compare(torch, got, want, od)
            head = (f"[kernels]   {name} {label} {od} {passes} pass"
                    f"{'es' if passes > 1 else ''} out={tuple(got.shape)}: "
                    f"max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
                    f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                failures.append(f"{name} {label} {od} passes={passes}")
            rec = results[name]
            if od == "float32":
                rec["max_abs_err"] = max(rec["max_abs_err"], max_abs)
            if od == "float16" and passes == 1:
                say(head)
                continue
            work = launch_work(torch, dk, name, args, kw, dt, passes)
            # in turns: kernel, library, plain, kernel. A launch of 0.05 ms
            # is shorter than its enqueue, so the short ones replay a CUDA
            # graph
            first, _ = time_cuda_graph(lambda: kern(*args, **kwp))
            lib_ms = None
            if od == "float32":
                lib_ms, lib = time_cuda_graph(lambda: library(passes))
                # the library's TF32 pass rounds as it likes: held at the
                # check_data tolerance there, at the kernels' at fp32
                if not compare(torch, lib, want,
                               "float32" if passes == 3 else "float16")[2]:
                    failures.append(f"library call differs: {name} {label} "
                                    f"passes={passes}")
                del lib
            plain_ms, _ = time_cuda(lambda: plain(*args, **kwp),
                                    iterations=20)
            again, _ = time_cuda_graph(lambda: kern(*args, **kwp))
            ms = (first + again) / 2
            say(f"{head}; kernel {ms:.4f} ms ({first:.4f}, {again:.4f}); "
                f"bound {work['bound_ms']:.4f} ms ({work['bound_by']}: "
                f"{work['bytes'] / 1e6:.1f} MB, {work['flops'] / 1e9:.2f} "
                f"GFLOP x {passes} pass{'es' if passes > 1 else ''}), share "
                f"of bound {work['bound_ms'] / ms:.0%}; library "
                f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}; plain "
                f"{plain_ms:.4f} ms")
            if keep and od == "float32":
                times = dict(ms=ms, plain_ms=plain_ms,
                             bound_ms=work["bound_ms"],
                             bound_by=work["bound_by"], library_ms=lib_ms)
                if passes == 3:
                    rec.update(times)
                else:
                    rec["one_pass"] = times
    return failures


def bsr_route(fat_group: int, block_width: int, k: int) -> str:
    """The route csrc/bsr_dense.cu's launch() takes: the resident (wgmma)
    route where G >= 2 and the column block with a 3- (else 2-) stage ring
    fits kMaxSmem (resident_bytes), else the streaming (mma.sync) route;
    the constants are read from the sources."""
    src = HERE / PKG / "csrc"
    c = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                             (src / f).read_text()).group(1))
         for name, f in (("kPadK", "tile_mma.cuh"),
                         ("kMaxSmem", "tile_mma.cuh"),
                         ("kSlabK", "tile_wgmma.cuh"),
                         ("kUnitRows", "bsr_dense.cu"))}

    def resident_bytes(stages):
        k32 = -(-k // c["kSlabK"]) * c["kSlabK"]
        stride = ((k + 7) & ~7) + c["kPadK"]
        return 1024 + 4 * (2 * block_width * k32
                           + stages * c["kUnitRows"] * stride)

    stages = 3 if resident_bytes(3) <= c["kMaxSmem"] else 2
    if fat_group >= 2 and resident_bytes(stages) <= c["kMaxSmem"]:
        return "resident (wgmma)"
    return "streaming (mma.sync)"


def check_kernels(torch, bt, dev, csr, results):
    """Phase 3: bsr_dense and subpack at the shapes of bsr plans; bsr_dense
    alone at K=64 and K=256 (the depths the bench adds) on the fat plan."""
    from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
    from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan
    pipe = bt.BsmrSddmm(csr, bt.SddmmConfig(alpha=0.3, delta=0.002,
                                            subpack_min_nnz=12))
    failures = []
    for k in (128, 32, 64, 256):
        A = torch.from_numpy(bt.make_dense(csr.rows, k, seed=1337)).to(dev)
        Bt = torch.from_numpy(
            bt.make_dense(k, csr.cols, seed=1338).T.copy()).to(dev)
        for fat in ((32, 1) if k in (128, 32) else (32,)):
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
            label = (f"G={plan.fat_group} K={k} "
                     f"{bsr_route(plan.fat_group, plan.block_width, k)}")
            failures += check_case(
                torch, dk, results, "bsr_dense", label,
                (A_panels, Bt, dp.tile_panel, dp.tile_src),
                dict(fat_group=plan.fat_group, block_width=plan.block_width),
                keep=(k, fat) == (128, 32))
            if fat != 1 and plan.num_packed and k in (128, 32):
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
            f"sddmm_eager_ms {log.extras['sddmm_eager_ms']}, "
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


#: [main]'s settings runs on the fp32 bsr cells of MAIN: (tier_serialize,
#: matmul_precision); "auto" lets both plans overlap, and forks the
#: captured (replayed) call only
SETTINGS = (("on", "bf16x3"), ("off", "bf16x3"), ("auto", "default"))
#: the stream arms timed in turns: rounds, eager calls a round
STREAM_ROUNDS, STREAM_CALLS = 7, 50
#: the cell where "auto" serializes (_serialize_tiers True: a big-gather
#: footprint whose residual the v5e table prices above 0.45 of the call)
SERIAL_CELL = ("banded_mesh_64k", 256, 0.3, 0.002)


def stream_arms(torch, label, plan, cfg, A_t, Bt_t, dp, smi):
    """The body at tier_serialize "on", "off" and "auto" timed in turns
    (STREAM_ROUNDS rounds, the order flipped each round): the eager call
    (CUDA events over STREAM_CALLS back-to-back calls), the host's enqueue
    of those calls (perf_counter), and a replayed CUDA graph; the medians,
    each arm's forks, and whether the three agree bit for bit."""
    import statistics
    from bsmr_sddmm_tpu_torch.ops.sddmm import (_serialize_tiers,
                                                make_sddmm_body)
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda_graph
    modes = ("on", "off", "auto")
    bodies = {m: make_sddmm_body(plan, cfg.replace(tier_serialize=m),
                                 emit="rphm") for m in modes}
    outs = {m: b(A_t, Bt_t, dp) for m, b in bodies.items()}
    eager = {m: [] for m in modes}
    host = {m: [] for m in modes}
    replay = {m: [] for m in modes}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for r in range(STREAM_ROUNDS):
        for m in (modes if r % 2 else modes[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            for _ in range(STREAM_CALLS):
                bodies[m](A_t, Bt_t, dp)
            host[m].append((time.perf_counter() - t0) * 1e3 / STREAM_CALLS)
            end.record()
            end.synchronize()
            eager[m].append(start.elapsed_time(end) / STREAM_CALLS)
            if r < 3:
                replay[m].append(time_cuda_graph(bodies[m], A_t, Bt_t,
                                                 dp)[0])
    torch.cuda.synchronize()
    med = statistics.median
    equal = all(torch.equal(x, y) for m in modes[1:]
                for x, y in zip(outs[m], outs["on"]))
    # each replayed graph is a warm-up call and the captured one
    calls = 1 + STREAM_ROUNDS * STREAM_CALLS + 2 * 3
    want = {"on": 0, "off": calls,
            "auto": 0 if _serialize_tiers(plan, cfg) else 3}
    forks = {m: bodies[m].forks for m in modes}
    say(f"[main] {label} stream arms in turns ({STREAM_ROUNDS} rounds of "
        f"{STREAM_CALLS} eager calls, 3 replayed graphs; medians; {smi}):")
    for m in modes:
        say(f"[main]   tier_serialize={m}: replayed {med(replay[m]):.4f} ms"
            f", eager {med(eager[m]):.4f} ms a call (host enqueue "
            f"{med(host[m]):.4f} ms); calls that forked {forks[m]} of "
            f"{calls}")
    say(f"[main]   the three arms bit-equal tier by tier: {equal}")
    failures = [] if equal else [f"{label}: stream arms differ"]
    if forks != want:
        failures.append(f"{label}: forks {forks}, want {want}")
    return failures


def settings_path(torch, bt, dev, suite, results, smi):
    """[main], second part: the fp32 bsr cells of MAIN with the tiers on
    one stream ("on"), on two ("off") and in one TF32 pass ("default"),
    each BsmrSddmm.benchmark(validate=True), each kernel launched; the rphm
    outputs of "on" and "off" must be bit-equal; then the "bf16x3" cell
    with the caller's allow_tf32 = True, whose outputs must be bit-equal to
    those with False. Then each cell's stream arms in turns, and those of
    SERIAL_CELL, where "auto" keeps one stream."""
    from bsmr_sddmm_tpu_torch import datasets
    from bsmr_sddmm_tpu_torch.ops.sddmm import (_forks, _serialize_tiers,
                                                device_plan, make_sddmm_body)
    failures = []
    for name, alpha, delta, od, mode, gb, _, expect in MAIN:
        if (mode, gb, od) != ("bsr", "xla", "float32"):
            continue
        csr = suite[name]
        base = bt.SddmmConfig(k=128, alpha=alpha, delta=delta,
                              subpack_min_nnz=12)
        A = bt.make_dense(csr.rows, 128, seed=1337)
        B = bt.make_dense(128, csr.cols, seed=1338)
        A_t = torch.from_numpy(A).to(dev)
        Bt_t = torch.from_numpy(B.T.copy()).to(dev)
        pipe = bt.BsmrSddmm(csr, base, device=dev)
        plan = bt.pack_tiles(csr, pipe.reorder(), base)
        dp = device_plan(plan, dev, emit="rphm")
        outs = {}
        for serial, prec in SETTINGS + (("auto", "bf16x3"),):
            cfg = base.replace(tier_serialize=serial, matmul_precision=prec)
            tf32 = (serial, prec) == ("auto", "bf16x3")
            run = (f"{name} tier_serialize={serial} matmul_precision={prec}"
                   f"{' allow_tf32=True' if tf32 else ''}")
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                pipe.config = cfg
                zero_launches()
                log = pipe.benchmark(A, B, validate=True,
                                     time_csr_emit=False, file=name)
                launches = read_launches(results)
                outs[run] = make_sddmm_body(plan, cfg, emit="rphm")(
                    A_t, Bt_t, dp)
                torch.cuda.synchronize()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            overlap = not _serialize_tiers(plan, cfg)
            say(f"[main] {run}: two streams replayed "
                f"{overlap and _forks(cfg, True)}, eager "
                f"{overlap and _forks(cfg, False)}; check "
                f"{log.check_result} (error rate {log.error_rate}); "
                f"sddmm_ms {log.sddmm_ms:.4f} ({log.gflops:.1f} GFLOPS), "
                f"sddmm_eager_ms {log.extras['sddmm_eager_ms']}; launches "
                f"{launches}")
            if log.check_result != "pass":
                failures.append(f"{run}: check {log.check_result}")
            failures += [f"{run}: {kname} never launched" for kname in expect
                         if launches[kname] <= 0]
        runs = list(outs)
        for label, one, other in (("on and off", runs[0], runs[1]),
                                  ("allow_tf32 True and False", runs[3],
                                   runs[1])):
            equal = [torch.equal(x, y)
                     for x, y in zip(outs[one], outs[other])]
            say(f"[main] {name} rphm outputs of {label} bit-equal tier by "
                f"tier (dense, packed, gathered, residual): {equal}")
            if not all(equal):
                failures.append(f"{name}: rphm outputs of {label} differ")
        diff = max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(outs[runs[2]], outs[runs[1]])
                   if x.numel())
        say(f"[main] {name} one TF32 pass against three: max_abs "
            f"{diff:.3e}")
        failures += stream_arms(torch, f"{name} K=128", plan, base, A_t,
                                Bt_t, dp, smi)
    # the serialize side of "auto"
    name, k, alpha, delta = SERIAL_CELL
    csr = dict(datasets.SUITE)[name]()
    cfg = bt.SddmmConfig(k=k, alpha=alpha, delta=delta, subpack_min_nnz=12)
    plan = bt.pack_tiles(csr, bt.BsmrSddmm(csr, cfg, device=dev).reorder(),
                         cfg, k=k)
    serial = _serialize_tiers(plan, cfg)
    say(f"[main] {name} K={k} alpha={alpha} delta={delta}: tiles dense "
        f"{plan.num_tiles} packed {plan.num_packed} gathered "
        f"{plan.num_gathered} residual nnz {plan.residual_nnz}; "
        f"\"auto\" serializes: {serial}")
    if not serial:
        failures.append(f"{name} K={k}: \"auto\" does not serialize")
    A_t = torch.from_numpy(bt.make_dense(csr.rows, k, seed=1337)).to(dev)
    Bt_t = torch.from_numpy(bt.make_dense(k, csr.cols, seed=1338).T.copy()
                            ).to(dev)
    failures += stream_arms(torch, f"{name} K={k}", plan, cfg, A_t, Bt_t,
                            device_plan(plan, dev, emit="rphm"), smi)
    return failures


PROFILE = (("bsr", dict(alpha=0.3, delta=0.002)),
           ("reorder", dict(alpha=0.3, delta=0.05, col_mode="reorder",
                            gathered_backend="fused")))
PROFILE_CALLS = 20


def kernel_rows(prof):
    """(name, device us) of each device kernel in a torch.profiler trace:
    device rows only (an aten op's row repeats its kernels' time), and not
    the device spans of user annotations (record_function ranges such as
    bsmr::spmm_backward or the optimizer's step), which cover idle time."""
    from torch.autograd import DeviceType
    return [(e.key, getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("bsmr::", "Optimizer."))]


def union_ms(prof) -> float:
    """Milliseconds in which at least one device kernel of the trace runs
    (the rows of kernel_rows, by their intervals): the busy time of a call
    whose tiers overlap on two streams, where the sum of kernel times
    counts the overlap twice."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith(("bsmr::", "Optimizer.")))
    total, reach = 0.0, -math.inf
    for start, end in spans:
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def profile_phase(torch, bt, dev, csr, busy_ms):
    """torch.profiler over PROFILE_CALLS calls of the rphm body on
    banded_mesh_32k at K=128, bsr and reorder: device busy time (the sum
    of kernel times and the union of their intervals), host enqueue time
    and each device kernel's share per call, the busy union into
    ``busy_ms[mode]``. The body runs at tier_serialize "off": its eager
    calls fork as the replayed graph of [main]'s "auto" run does, so the
    busy time is that of the headline's schedule. Reports; fails only if
    the body does."""
    from torch.profiler import ProfilerActivity, profile
    from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan, make_sddmm_body
    A = torch.from_numpy(bt.make_dense(csr.rows, 128, seed=1337)).to(dev)
    Bt = torch.from_numpy(
        bt.make_dense(128, csr.cols, seed=1338).T.copy()).to(dev)
    for mode, arm in PROFILE:
        cfg = bt.SddmmConfig(k=128, subpack_min_nnz=12, **arm)
        plan = bt.pack_tiles(csr, bt.BsmrSddmm(csr, cfg).reorder(), cfg)
        dp = device_plan(plan, dev, emit="rphm")
        body = make_sddmm_body(plan, cfg.replace(tier_serialize="off"),
                               emit="rphm")
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
        rows = sorted(((key, us / PROFILE_CALLS / 1e3)
                       for key, us in kernel_rows(prof)
                       if us > 0), key=lambda kv: -kv[1])
        busy = sum(ms for _, ms in rows)
        if not busy:
            say(f"[profile] banded_mesh_32k {mode}: no device time in the "
                f"trace: not measured")
            continue
        busy_ms[mode] = union_ms(prof) / PROFILE_CALLS
        say(f"[profile] banded_mesh_32k K=128 {mode} {arm} "
            f"tier_serialize=off, per call over "
            f"{PROFILE_CALLS} calls (profiler on): wall "
            f"{wall * 1e3 / PROFILE_CALLS:.4f} ms, host enqueue "
            f"{enqueue * 1e3 / PROFILE_CALLS:.4f} ms, device busy "
            f"{busy_ms[mode]:.4f} ms (union of kernel intervals; sum of "
            f"kernel times {busy:.4f} ms)")
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
    """Phase 9: the console entry point on a suite matrix in a .mtx."""
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
        f"sddmm_ms {log.sddmm_ms:.4f} ({log.gflops:.1f} GFLOPS; eager "
        f"{float(log.extras['sddmm_eager_ms']):.4f}); tiles dense "
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


#: [arms]: the full grid (ALPHAS x CONFIGS) of bench.suite at K=128 on these
ARMS = ("banded_mesh_32k", "community_20k")
#: the refine probe's cell and the tier profile's matrix
ARMS_REFINE, ARMS_PROFILE = "community_20k", "banded_mesh_32k"
#: the refine probe's alphas: its grid less alpha 0.5, the slowest arms
ARMS_REFINE_ALPHAS = (0.1, 0.3)


def sweep_arms(dev, suite):
    """bench.suite.run(full_grid=True) at K=128 on ARMS: (its echoed lines,
    the result line, the suite's record of each arm that ran: matrix, k,
    alpha, delta, subpack, dtype, gflops, ms, check)."""
    from bsmr_sddmm_tpu_torch.bench import suite as bench_suite
    lines, records = [], []

    def echo(msg):
        lines.append(msg)
        say(f"[arms] {msg}")

    out = bench_suite.run([(n, lambda n=n: suite[n]) for n in ARMS],
                          ks=(128,), device=dev, full_grid=True, echo=echo,
                          records=records)
    return lines, out, records


def arms_phase(torch, bt, dev, suite, smi, results):
    """Phase 7: the arm-selection tools (bsmr_sddmm_tpu_torch.tools) on the
    card over the suite's own sweep: the full grid of ARMS at K=128, every
    arm timed and each matrix's first arm validated; check_autotune on the
    suite's arm records (the positional parse of the echoed lines held to
    them) and the V5E_COSTS host pick as a fraction of the sweep best, a
    pick the sweep lacks timed on the card; audit_cost_model on those arms;
    fit_costs_from_audit on the subpack-0 rows, written to the card's cost
    cache, read back by current_costs() and the pick checked again under
    it; probe_refine_pick on ARMS_REFINE; profile_tiers on ARMS_PROFILE.
    Leaves V5E_COSTS in effect and no cache file after it."""
    from bsmr_sddmm_tpu_torch import autotune
    from bsmr_sddmm_tpu_torch.bench import suite as bench_suite
    from bsmr_sddmm_tpu_torch.tools import audit_cost_model as audit_tool
    from bsmr_sddmm_tpu_torch.tools import check_autotune as check_tool
    from bsmr_sddmm_tpu_torch.tools import fit_costs_from_audit as fit_tool
    from bsmr_sddmm_tpu_torch.tools import probe_refine_pick, profile_tiers
    if autotune.current_costs() is not autotune.V5E_COSTS:
        return ["arms: the cost table in effect is not V5E_COSTS"]
    failures = []
    gens = [(n, lambda n=n: suite[n]) for n in ARMS]
    zero_launches()
    t0 = time.perf_counter()
    lines, out, records = sweep_arms(dev, suite)
    fp32 = [r for r in records if r["dtype"] == "float32"]
    say(f"[arms] sweep: {len(fp32)} fp32 arms and "
        f"{len(records) - len(fp32)} fp16 in {time.perf_counter() - t0:.1f} "
        f"s")
    failures += [f"arms: sweep {key} {out[key]}"
                 for key in ("failed_cells", "budget_skipped") if key in out]
    want = len(ARMS) * len(bench_suite.ALPHAS) * len(bench_suite.CONFIGS)
    if len(fp32) != want:
        failures.append(f"arms: {len(fp32)} fp32 arms timed, {want} wanted")
    for name in ARMS:
        first = next((r for r in fp32 if r["matrix"] == name), None)
        if first is None or first["check"] != "pass":
            failures.append(f"arms: {name}'s first arm check "
                            f"{first and first['check']}")

    # 2. check_autotune on the suite's records; the positional parse of the
    # echoed lines must agree with them unless an arm was skipped or failed
    runs = check_tool.runs_from_records(records)
    parsed = {key: dict(grid)
              for key, grid in check_tool.parse_lines(lines).items()}
    rounded = {key: {arm: float(f"{g:.0f}") for arm, g in grid.items()}
               for key, grid in runs.items()}
    shifted = [ln for ln in lines if "skipped (plan maps" in ln
               or "FAILED twice" in ln]
    if parsed != rounded and not shifted:
        failures.append(f"arms: parse_log {parsed} differs from the arm "
                        f"records {rounded} with no arm skipped or failed")
    say(f"[arms] check_autotune reads {sum(map(len, runs.values()))} arms "
        f"from the suite's records; the positional parse of the echoed "
        f"lines agrees with them: {'yes' if parsed == rounded else 'no'} "
        f"({len(shifted)} arms skipped or failed)")

    def picks(tag, costs):
        t = time.perf_counter()
        got = check_tool.check(runs, gens, ks=(128,), auto_alpha=True,
                               costs=costs, time_outside_grid=dev,
                               echo=lambda m: say(f"[arms] {tag}: {m}"))
        # a pick the grid lacks (e.g. delta 0.006 at subpack 12) is timed
        # on the card, so that every row has a fraction
        outside = [r["picked"] for r in got["rows"]
                   if r.get("timed_outside_grid")]
        say(f"[arms] {tag} host pick over the sweep best: mean "
            f"{got['mean_fraction']}, min {got['min_fraction']} (picks "
            f"outside the swept grid, timed on the card: {outside}; "
            f"{time.perf_counter() - t:.1f} s)")
        if len(got["rows"]) != len(ARMS):
            failures.append(f"arms: {tag} check rows {got['rows']}")
        failures.extend(f"arms: {tag} row without a fraction {r}"
                        for r in got["rows"] if r["fraction"] is None)
        return got

    v5e = picks("V5E_COSTS", autotune.V5E_COSTS)

    # 3. audit_cost_model on the arms just timed, a table per subpack
    plans = {}

    def plan_for(r):
        key = (r["file"], r["sub"])
        if key not in plans:
            plans[key] = bt.BsmrSddmm(suite[r["file"]], bt.SddmmConfig(
                k=128, panel_height=32, subpack_min_nnz=r["sub"],
                reorder_cache=True))
        # the SUITE has no manifest regime: each matrix stands for its own
        return plans[key].plan(r["alpha"], r["delta"], k=128), r["file"]

    audits = {}
    for sub in sorted({r["subpack"] for r in fp32}):
        recs = [dict(file=r["matrix"], k=128, alpha=r["alpha"],
                     delta=r["delta"], ms=r["ms"], sub=sub)
                for r in fp32 if r["subpack"] == sub]
        audits[sub] = audit_tool.audit(recs, plan_for, autotune.V5E_COSTS,
                                       echo=lambda _: None)
        for name, per_k in audits[sub]["per_regime_k"].items():
            g = per_k["128"]
            say(f"[arms] audit subpack {sub} {name} K=128: measured / "
                f"V5E_COSTS estimate geomean {g['geomean']} (n {g['n']}, "
                f"min {g['min']}, max {g['max']})")
        if audits[sub]["cells"] != len(recs):
            failures.append(f"arms: audit subpack {sub} priced "
                            f"{audits[sub]['cells']} of {len(recs)} arms")

    # 4. fit_costs_from_audit on the subpack-0 rows, into the card's cache
    got = fit_tool.fit(audits[0]["rows"])
    table = got["table"]
    say(f"[arms] refit on {len(audits[0]['rows'])} subpack-0 rows ({smi}; "
        f"one K, so each base and its K slope are not told apart): quality "
        f"(geomean |log ratio|) V5E_COSTS {got['quality']['defaults']}, "
        f"refit {got['quality']['refit']}")
    v5e_units = dict(autotune.V5E_COSTS)
    for key, val in table.items():
        say(f"[arms]   {key:20s} V5E_COSTS {v5e_units[key]:12.4f} refit "
            f"{val:12.4f}")
    bad = [k for k, v in table.items() if not math.isfinite(v)]
    if bad:
        failures.append(f"arms: refit constants not finite: {bad}")
    kind = torch.cuda.get_device_name()
    path = fit_tool.write_cache(table, kind)
    try:
        autotune._CALIBRATED = None
        with open(path) as f:
            merged = autotune._merge_costs(json.load(f))
        cur = autotune.current_costs()
        ok = cur == merged and all(cur[k] == v for k, v in table.items()
                                   if k != "fixed_us")
        say(f"[arms] wrote {os.path.basename(path)}; current_costs() reads "
            f"the merged refit: {'yes' if ok else 'NO'}")
        if not ok:
            failures.append("arms: current_costs() did not read the "
                            "written refit")
        refit = picks("refit", None)
    finally:
        os.remove(path)
        autotune._CALIBRATED = None
    if autotune.current_costs() is not autotune.V5E_COSTS:
        failures.append("arms: V5E_COSTS not back in effect")

    # 5. probe_refine_pick: host and refined picks on one cell
    t = time.perf_counter()
    row = probe_refine_pick.probe_cell(
        ARMS_REFINE, suite[ARMS_REFINE], 128, dev,
        echo=lambda m: say(f"[arms] refine probe {m}"),
        alphas=ARMS_REFINE_ALPHAS)
    say(f"[arms] refine probe {ARMS_REFINE} K=128 ({smi}): sweep best "
        f"{row['sweep_best']}; host pick {row['host_pick']}; refined pick "
        f"{row['refined_pick']} ([arm, ms, fraction of best]; "
        f"{time.perf_counter() - t:.1f} s)")
    for key in ("host_pick", "refined_pick"):
        if not 0 < row[key][2] <= 1.0:
            failures.append(f"arms: refine probe {key} {row[key]}")

    # 6. profile_tiers on one matrix
    prof = profile_tiers.profile([ARMS_PROFILE], 128, dev,
                                 echo=lambda m: say(f"[arms] tiers {m}"))
    if len(prof) != 1 or not prof[0]["tier_ms"]["dense"] > 0:
        failures.append(f"arms: profile_tiers {prof}")

    launches = read_launches(results)
    say(f"[arms] pick fractions of the sweep best (K=128, {smi}): V5E_COSTS "
        f"host {[r['fraction'] for r in v5e['rows']]}, refit host "
        f"{[r['fraction'] for r in refit['rows']]} ({ARMS}); "
        f"{ARMS_REFINE} probe host {row['host_pick'][2]}, refined "
        f"{row['refined_pick'][2]}; launches {launches}")
    for kname in ("bsr_dense", "subpack"):
        if launches[kname] <= 0:
            failures.append(f"arms: {kname} never launched")
    return failures


def dense_phase(bt, dev, results):
    """Phase 8: the dense fallback against the best-priced tiled plan on a
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


#: the banded bsr run's sddmm_ms (a replayed CUDA graph) against the device
#: busy time [profile] reads for the same body (the union of its kernels'
#: intervals: the tiers overlap on two streams): a replay adds the gaps
#: between its ~10 kernels, which busy time leaves out
HEADLINE_RTOL = 0.15


def check_headline(picks, busy_ms) -> list:
    """[main]: the banded bsr run's sddmm_ms within HEADLINE_RTOL of
    [profile]'s device busy (union) for that body."""
    ms = picks["banded_mesh_32k"]["fixed arm"][3]
    busy = busy_ms.get("bsr")
    if busy is None:
        return ["headline: [profile] read no device time for the bsr body"]
    off = ms / busy - 1
    say(f"[main] banded_mesh_32k bsr: sddmm_ms {ms:.4f} against device busy "
        f"(union) {busy:.4f} ms ({off:+.1%}; limit {HEADLINE_RTOL:.0%})")
    if abs(off) > HEADLINE_RTOL:
        return [f"headline: sddmm_ms {ms:.4f} is {off:+.1%} off device busy "
                f"{busy:.4f} ms"]
    return []


# the training path: models at the sizes the JAX package trains on hardware
# (.claude/skills/verify/SKILL.md, scripts/verify_drive.py:85-87) and the
# graph transformer on the SUITE graph-community stand-in
SEQ_MODEL = dict(seq_len=2048, vocab_size=64, head_dim=128, num_heads=2,
                 num_layers=1)
SEQ_MASK = dict(window=128, stride=64)
GRAPH_MODEL = dict(num_nodes=20000, feature_dim=16, head_dim=128)
GRAPH_CFG = dict(k=128, alpha=0.1, delta=0.002, subpack_min_nnz=12)
# kernels vs plain on the same weights: logits to rtol/atol LOGIT_TOL, each
# parameter's gradient to rtol 1e-3 and atol 1e-4 x its largest |g| (the
# CPU tests' tolerance against the JAX package). The kernels' three TF32
# passes agree with fp32 products to a few ulps of each sum, and index_add
# on the card sums in no fixed order.
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-3, 1e-4
#: the graph transformer's descent check (its timed steps take the JAX
#: package's default, 1e-3)
GRAPH_SMALL_LR = 1e-5
#: rounds of [train]'s step timing in turns
STEP_ROUNDS = 5
#: substrings of the hand kernels' device names
HAND = ("bsr_resident_kernel", "bsr_stream_kernel", "subpack_kernel",
        "gathered_tile_kernel")


def max_err(torch, got, want):
    """(max |got - want|, ok at LOGIT_TOL)."""
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * want.abs()).all())
    return float(diff.max()), ok


def grad_errors(net, plain):
    """Per parameter: (name, max |g - g_plain|, its limit)."""
    out = []
    for (name, p), (_, q) in zip(net.named_parameters(),
                                 plain.named_parameters()):
        diff = (p.grad - q.grad).abs()
        limit = GRAD_ATOL_SCALE * float(q.grad.abs().max()) \
            + GRAD_RTOL * q.grad.abs()
        out.append((name, float(diff.max()), bool((diff <= limit).all())))
    return out


def step_split(torch, step, *args):
    """One train step under torch.profiler: device ms in the hand kernels,
    in the rest of the SDDMM body (bsmr::sddmm_body), in the backward
    SpMMs (bsmr::spmm_backward) and in the rest; and the step's loss."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss = step(*args)
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    total = sum(us for _, us in rows) / 1e3
    hand = sum(us for key, us in rows if any(h in key for h in HAND)) / 1e3
    by_label = {}

    def walk(ev, label):
        if ev.name.startswith("bsmr::"):
            label = ev.name
        for k in ev.kernels:
            if not any(h in k.name for h in HAND):
                by_label[label] = by_label.get(label, 0.0) + k.duration / 1e3
        for child in ev.cpu_children:
            walk(child, label)

    for ev in prof.events():
        if ev.cpu_parent is None and ev.device_type == DeviceType.CPU:
            walk(ev, "rest")
    body = by_label.get("bsmr::sddmm_body", 0.0)
    spmm = by_label.get("bsmr::spmm_backward", 0.0)
    top = sorted(rows, key=lambda kv: -kv[1])[:8]
    return dict(total=total, hand=hand, body=body, spmm=spmm,
                rest=total - hand - body - spmm,
                top=[(key, us / 1e3) for key, us in top]), loss


def say_split(tag, split, smi, phase="train"):
    if not split["total"]:
        say(f"[{phase}] {tag}: no device time in the trace: not measured")
        return
    parts = ", ".join(
        f"{label} {split[key]:.3f} ms ({split[key] / split['total']:.0%})"
        for key, label in (("hand", "hand kernels"),
                           ("body", "rest of the SDDMM body"),
                           ("spmm", "backward SpMMs"), ("rest", "the rest")))
    say(f"[{phase}] {tag} one step under torch.profiler: device busy "
        f"{split['total']:.3f} ms: {parts}; {smi}")
    for key, ms in split["top"]:
        say(f"[{phase}]   {ms:.3f} ms {ms / split['total']:5.1%}  "
            f"{key[:100]}")


def head_against_csr(torch, head_fn, dplan, csr, k, dev):
    """One attention head at full size through the tile layout (the hand
    kernels forward, the tile-layout products backward) against the CSR
    oracles of ``ops.graph``, which autograd differentiates as they are and
    which share no code with the tile layout: (max |out err|, the worst
    gradient's (name, max err), ok at LOGIT_TOL and the gradient
    tolerance)."""
    import numpy as np
    from bsmr_sddmm_tpu_torch.ops import graph
    rng = np.random.default_rng(3)
    q, kk, v, w = (torch.from_numpy(rng.standard_normal((n, k)).astype(
        np.float32)).to(dev) for n in (csr.rows, csr.cols, csr.cols,
                                       csr.rows))
    seg = torch.from_numpy(graph.csr_segment_ids(csr)).to(dev)
    col = torch.from_numpy(csr.col_indices.astype(np.int64)).to(dev)

    def oracle(q, kk, v, _):
        s = (q.index_select(0, seg) * kk.index_select(0, col)).sum(1)
        alpha = graph.edge_softmax(s / math.sqrt(k), seg, csr.rows)
        return graph.spmm(alpha, col, seg, v, csr.rows)

    runs = []
    for fn in (head_fn, oracle):
        xs = [x.clone().requires_grad_() for x in (q, kk, v)]
        out = fn(*xs, dplan)
        (out * w).sum().backward()
        runs.append((out.detach(), [x.grad for x in xs]))
    (out, grads), (want, wgrads) = runs
    err, ok = max_err(torch, out, want)
    worst = ("", 0.0)
    for name, g, wg in zip(("dq", "dk", "dv"), grads, wgrads):
        diff = (g - wg).abs()
        limit = GRAD_ATOL_SCALE * float(wg.abs().max()) \
            + GRAD_RTOL * wg.abs()
        ok = ok and bool((diff <= limit).all())
        worst = max(worst, (name, float(diff.max())), key=lambda x: x[1])
    return err, worst, ok


def train_phase(torch, bt, dev, csr, results, smi):
    """Phase 10: both model families trained through the hand kernels (the
    graph transformer on ``csr``, community_20k)."""
    import numpy as np
    from bsmr_sddmm_tpu_torch.models import graph_transformer as gt
    from bsmr_sddmm_tpu_torch.models import sparse_transformer as st
    failures = []
    # --- sparse transformer -------------------------------------------
    model = st.SparseTransformer(**SEQ_MODEL)
    cfg = bt.SddmmConfig(k=128, delta=0.05)
    t0 = time.perf_counter()
    net, dplan, plan = st.make_forward(model, config=cfg, device=dev,
                                       **SEQ_MASK)
    plain, pdplan, _ = st.make_forward(model, config=cfg.replace(
        backend="torch"), device=dev, **SEQ_MASK)
    say(f"[train] sparse transformer {SEQ_MODEL} {SEQ_MASK}: mask nnz "
        f"{plan.nnz}, G={plan.fat_group} tiles dense {plan.num_tiles} "
        f"packed {plan.num_packed} gathered {plan.num_gathered} residual nnz "
        f"{plan.residual_nnz}; two nets built in "
        f"{time.perf_counter() - t0:.1f} s")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.vocab_size, model.seq_len)).to(dev)
    want = tuple(k for k, n in (("bsr_dense", plan.num_tiles),
                                ("subpack", plan.num_packed)) if n)
    zero_launches()
    with torch.no_grad():
        logits = net(tokens, dplan)
    st.loss_fn(net, tokens, dplan).backward()
    torch.cuda.synchronize()
    launches = read_launches(results)
    with torch.no_grad():
        err, ok = max_err(torch, logits, plain(tokens, pdplan))
    st.loss_fn(plain, tokens, pdplan).backward()
    grads = grad_errors(net, plain)
    worst = max(grads, key=lambda g: g[1])
    say(f"[train]   kernels vs plain: logits max_abs {err:.3e} "
        f"({'ok' if ok else 'MISMATCH'} at {LOGIT_TOL}); gradients of "
        f"{len(grads)} parameters, largest max_abs {worst[1]:.3e} "
        f"({worst[0]}), {'all ok' if all(g[2] for g in grads) else 'MISMATCH'}"
        f" at rtol {GRAD_RTOL} + atol {GRAD_ATOL_SCALE} x max|g|; launches "
        f"{launches}")
    if not ok:
        failures.append(f"train sparse: logits off by {err:.3e}")
    failures += [f"train sparse: gradient of {n} off by {e:.3e}"
                 for n, e, good in grads if not good]
    failures += [f"train sparse: {k} never launched" for k in want
                 if launches[k] <= 0]
    del plain, pdplan, logits
    opt_init, step = st.make_train_step(model, net)
    opt = opt_init()
    zero_launches()
    losses = [step(opt, tokens, dplan)]                 # warm-up step
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses += [step(opt, tokens, dplan) for _ in range(2)]
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / 2
    launches = read_launches(results)
    split, extra = step_split(torch, step, opt, tokens, dplan)
    losses = [float(x) for x in losses] + [float(extra)]
    say(f"[train]   Adam steps: losses {[round(x, 5) for x in losses]}; "
        f"{step_ms:.3f} ms per step (CUDA events, steps 2-3); launches "
        f"{launches}")
    say_split("sparse transformer", split, smi)
    if not (all(math.isfinite(x) for x in losses) and losses[2] < losses[0]):
        failures.append(f"train sparse: losses {losses}")
    failures += [f"train sparse steps: {k} never launched" for k in want
                 if launches[k] <= 0]
    del net, opt
    # --- graph transformer on community_20k -----------------------------
    gmodel = gt.GraphTransformer(**GRAPH_MODEL)
    gcfg = bt.SddmmConfig(**GRAPH_CFG)
    t0 = time.perf_counter()
    gnet, gdplan, gplan = gt.make_forward(gmodel, csr, config=gcfg,
                                          device=dev)
    gplain, gpdplan, _ = gt.make_forward(gmodel, csr, config=gcfg.replace(
        backend="torch"), device=dev)
    say(f"[train] graph transformer {GRAPH_MODEL} (4 heads, 2 layers, 8 "
        f"classes) on community_20k {GRAPH_CFG}: G={gplan.fat_group} tiles "
        f"dense {gplan.num_tiles} packed {gplan.num_packed} gathered "
        f"{gplan.num_gathered} residual nnz {gplan.residual_nnz}; two nets "
        f"built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.standard_normal(
        (gmodel.num_nodes, gmodel.feature_dim)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(
        0, gmodel.num_classes, gmodel.num_nodes)).to(dev)
    gwant = tuple(k for k, n in (("bsr_dense", gplan.num_tiles),
                                 ("subpack", gplan.num_packed)) if n)
    zero_launches()
    with torch.no_grad():
        got = gnet(X, gdplan)
    gt.loss_fn(gnet, X, labels, gdplan).backward()
    torch.cuda.synchronize()
    launches = read_launches(results)
    with torch.no_grad():
        err, ok = max_err(torch, got, gplain(X, gpdplan))
    gt.loss_fn(gplain, X, labels, gpdplan).backward()
    grads = grad_errors(gnet, gplain)
    worst = max(grads, key=lambda g: g[1])
    say(f"[train]   kernels vs plain: logits max_abs {err:.3e} "
        f"({'ok' if ok else 'MISMATCH'}); gradients of {len(grads)} "
        f"parameters, largest max_abs {worst[1]:.3e} ({worst[0]}), "
        f"{'all ok' if all(g[2] for g in grads) else 'MISMATCH'}; launches "
        f"{launches}")
    if not ok:
        failures.append(f"train graph: logits off by {err:.3e}")
    failures += [f"train graph: gradient of {n} off by {e:.3e}"
                 for n, e, good in grads if not good]
    failures += [f"train graph: {k} never launched" for k in gwant
                 if launches[k] <= 0]
    del gplain, gpdplan, got
    # independent of the tile layout: one head against the CSR oracles
    t0 = time.perf_counter()
    err, (gname, gerr), ok = head_against_csr(torch, gnet.head_fn, gdplan,
                                              csr, gmodel.head_dim, dev)
    say(f"[train]   one head (q, k, v normal, K={gmodel.head_dim}) against "
        f"the CSR oracles of ops.graph under autograd: out max_abs "
        f"{err:.3e}, worst gradient {gname} max_abs {gerr:.3e}, "
        f"{'ok' if ok else 'MISMATCH'} at {LOGIT_TOL} / rtol {GRAD_RTOL} + "
        f"atol {GRAD_ATOL_SCALE} x max|g|; {time.perf_counter() - t0:.1f} s")
    if not ok:
        failures.append(f"train graph: head off the CSR oracles by {err:.3e}"
                        f" / {gname} {gerr:.3e}")
    # Adam's first step moves every weight by lr; at GRAPH_SMALL_LR it must
    # lower the loss from the same weights, which are then put back
    start_weights = {n: p.detach().clone() for n, p in gnet.named_parameters()}
    opt_init, gstep = gt.make_train_step(gmodel, gnet, GRAPH_SMALL_LR)
    small = [float(gstep(opt_init(), X, labels, gdplan))]
    with torch.no_grad():
        small.append(float(gt.loss_fn(gnet, X, labels, gdplan)))
        for n, p in gnet.named_parameters():
            p.copy_(start_weights[n])
    say(f"[train]   one Adam step at lr {GRAPH_SMALL_LR}: loss {small[0]:.5f}"
        f" -> {small[1]:.5f}")
    if not small[1] < small[0]:
        failures.append(f"train graph: lr {GRAPH_SMALL_LR} step took the "
                        f"loss {small[0]} -> {small[1]}")
    del start_weights
    opt_init, gstep = gt.make_train_step(gmodel, gnet)
    opt = opt_init()
    zero_launches()
    t0 = time.perf_counter()
    loss = float(gstep(opt, X, labels, gdplan))
    wall = time.perf_counter() - t0
    launches = read_launches(results)
    start.record()
    loss2 = gstep(opt, X, labels, gdplan)
    end.record()
    end.synchronize()
    split, loss3 = step_split(torch, gstep, opt, X, labels, gdplan)
    say(f"[train]   Adam steps: losses {loss:.5f}, {float(loss2):.5f}, "
        f"{float(loss3):.5f}; first step {wall:.2f} s wall, second "
        f"{start.elapsed_time(end):.3f} ms (CUDA events); launches of the "
        f"first {launches}")
    say_split("graph transformer", split, smi)
    if not math.isfinite(loss):
        failures.append(f"train graph: loss {loss}")
    failures += [f"train graph step: {k} never launched" for k in gwant
                 if launches[k] <= 0]
    failures += step_streams(torch, gt, gmodel, csr, gcfg, dev, X, labels,
                             smi)
    return failures


def step_streams(torch, gt, gmodel, csr, gcfg, dev, X, labels, smi):
    """The graph transformer's Adam step at tier_serialize "auto" (its
    eager SDDMM calls on one stream) and "off" (each forked onto the side
    stream), timed in turns: STEP_ROUNDS rounds of two steps, CUDA events;
    the medians."""
    import statistics
    steps = {}
    for mode in ("auto", "off"):
        net, dplan, _ = gt.make_forward(gmodel, csr, config=gcfg.replace(
            tier_serialize=mode), device=dev)
        opt_init, step = gt.make_train_step(gmodel, net, GRAPH_SMALL_LR)
        steps[mode] = (step, opt_init(), dplan)
        step(steps[mode][1], X, labels, dplan)              # warm-up
    ms = {mode: [] for mode in steps}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for r in range(STEP_ROUNDS):
        for mode in (("auto", "off") if r % 2 else ("off", "auto")):
            step, opt, dplan = steps[mode]
            torch.cuda.synchronize()
            start.record()
            losses = [step(opt, X, labels, dplan) for _ in range(2)]
            end.record()
            end.synchronize()
            ms[mode].append(start.elapsed_time(end) / 2)
            if not all(math.isfinite(float(x)) for x in losses):
                return [f"train graph step {mode}: losses {losses}"]
    med = statistics.median
    say(f"[train]   graph transformer Adam step, tier_serialize in turns "
        f"({STEP_ROUNDS} rounds of 2 steps, CUDA events, medians): \"auto\" "
        f"{med(ms['auto']):.3f} ms, \"off\" {med(ms['off']):.3f} ms; {smi}")
    return []


BATCH_Z = 4


def batched_phase(torch, bt, dev, csr, results):
    """Phase 11: make_batched_sddmm_fn at Z=BATCH_Z on the community_20k
    plan at K=128 against BATCH_Z single calls of the body."""
    import numpy as np
    from bsmr_sddmm_tpu_torch.ops.sddmm import (device_plan,
                                                make_batched_sddmm_fn,
                                                make_sddmm_body)
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda_graph
    cfg = bt.SddmmConfig(**GRAPH_CFG)
    plan = bt.BsmrSddmm(csr, cfg, device=dev).plan()
    dp = device_plan(plan, dev, emit="rphm")
    A = torch.from_numpy(np.stack([bt.make_dense(csr.rows, 128, seed=1337 + z)
                                   for z in range(BATCH_Z)])).to(dev)
    Bt = torch.from_numpy(np.stack([
        bt.make_dense(128, csr.cols, seed=2337 + z).T
        for z in range(BATCH_Z)])).to(dev).contiguous()
    fn = make_batched_sddmm_fn(plan, cfg, emit="rphm")
    zero_launches()
    got = fn(A, Bt, dp)
    torch.cuda.synchronize()
    launches = read_launches(results)
    body = make_sddmm_body(plan, cfg, emit="rphm")
    worst, ok = 0.0, True
    for z in range(BATCH_Z):
        for tier, one in zip(got, body(A[z], Bt[z], dp)):
            err, _, good = compare(torch, tier[z], one, "float32")
            worst, ok = max(worst, err), ok and good
    batch_ms, _ = time_cuda_graph(fn, A, Bt, dp, iterations=10)
    one_ms, _ = time_cuda_graph(body, A[0], Bt[0], dp, iterations=10)
    say(f"[batched] community_20k K=128 Z={BATCH_Z} {GRAPH_CFG}: tiers "
        f"{[tuple(t.shape) for t in got]}; against single calls max_abs "
        f"{worst:.3e} ({'ok' if ok else 'MISMATCH'} at {TOL['float32']}); "
        f"launches {launches}; {batch_ms:.4f} ms a batch (replayed graph), "
        f"{one_ms:.4f} ms a single call")
    failures = [] if ok else [f"batched: off by {worst:.3e}"]
    failures += [f"batched: {k} launched {launches[k]} times, not {BATCH_Z}"
                 for k, n in (("bsr_dense", plan.num_tiles),
                              ("subpack", plan.num_packed))
                 if n and launches[k] != BATCH_Z]
    return failures


# K=64 left out since [arms] runs its full grid: every route is covered
# (resident at K=128, streaming at K=256) and the script stays near 10 min
BENCH_KS = (128, 256)
BENCH_SCHEMA = ("metric", "value", "unit", "vs_baseline", "per_k_geomean",
                "per_k_vs_baseline", "per_k_geomean_fp32out",
                "matrices_per_k")


def bench_phase(torch, bt, dev, suite, results):
    """Phase 17: bench.suite.run on banded_mesh_32k and community_20k at
    K in BENCH_KS with their R4_BEST arms (4 cells and community_20k's fp16
    sibling at K=128), every arm validated, the launches of each K's cells
    counted; then a bench.runner -> bench.analyze round trip through
    subprocesses on the card."""
    import csv
    import glob
    from bsmr_sddmm_tpu_torch.bench import analyze, runner
    from bsmr_sddmm_tpu_torch.bench import suite as bench_suite
    from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
    names = ("banded_mesh_32k", "community_20k")
    per_k = {k: {"bsr_dense": 0, "subpack": 0} for k in BENCH_KS}
    seen = {"bsr_dense": 0, "subpack": 0}
    checks, routes = [], {k: [] for k in BENCH_KS}

    def echo(msg):
        say(f"[bench] {msg}")
        m = re.match(r"# \S+ (?:a=\S+ d=\S+ )?k=(\d+)", msg)
        if m:   # the launches since the last cell line are this cell's
            for kname in seen:
                n = getattr(dk, kname).launches
                per_k[int(m.group(1))][kname] += n - seen[kname]
                seen[kname] = n
        arm = re.match(r"# (\S+) a=\S+ d=\S+ k=(\d+)( dt=f16)?: .* "
                       r"G=(\d+) .* check (\w+)$", msg)
        if arm:
            name, k, _, G, check = arm.groups()
            checks.append(check)
            routes[int(k)].append(f"{name} G={G} "
                                  f"{bsr_route(int(G), 128, int(k))}")

    zero_launches()
    out = bench_suite.run([(n, lambda n=n: suite[n]) for n in names],
                          ks=BENCH_KS, budget_s=900.0, device=dev,
                          echo=echo)
    launches = read_launches(results)
    failures = [f"bench: {key} {out[key]}"
                for key in ("failed_cells", "budget_skipped") if key in out]
    failures += [f"bench: no {key} in the result" for key in BENCH_SCHEMA
                 if key not in out]
    if out.get("matrices_per_k") != {str(k): 2 for k in BENCH_KS}:
        failures.append(f"bench: matrices_per_k {out.get('matrices_per_k')}")
    want = 2 * len(BENCH_KS) + 1
    if checks != ["pass"] * want:
        failures.append(f"bench: {want} validated arms expected, checks "
                        f"{checks}")
    say(f"[bench] per-K geomean GFLOPS {out.get('per_k_geomean')}, fp32 "
        f"out {out.get('per_k_geomean_fp32out')}, vs the RTX 4090 baseline "
        f"{out.get('per_k_vs_baseline')}")
    for k in BENCH_KS:
        say(f"[bench] K={k}: launches {per_k[k]}; bsr_dense routes "
            f"{routes[k]}")
    if per_k[256]["bsr_dense"] <= 0:
        failures.append("bench: bsr_dense never launched at K=256")
    say(f"[bench] launches over the sweep {launches}")

    # runner -> analyze: the CLI and the gather_dot baseline, each in a
    # process of its own on the card, read back by the analyzer
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(HERE), os.environ.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "community_20k.mtx")
        bt.formats.save_mtx(path, suite["community_20k"])
        log_dir = os.path.join(tmp, "logs")
        statuses = runner.run_suite(
            [path], log_dir, ks=(128,), alphas=(0.1,), deltas=(0.002,),
            baselines=("gather_dot",), validate=True, fast_bench=True,
            echo=lambda m: say(f"[bench] runner {m}"))
        failures += [f"bench: runner {s}" for s in statuses
                     if s["returncode"] != 0]
        a = analyze.analyze_logs(sorted(glob.glob(f"{log_dir}/*.log")),
                                 k=128)
        with open(analyze.write_results_csv(a, tmp)) as f:
            rows = list(csv.DictReader(f))
        say(f"[bench] analyze: rows {rows}; accuracy {a.accuracy}; "
            f"bsmr over gather_dot {a.speedup_geomean}")
        if len(rows) != 1 or not (rows[0].get("bsmr")
                                  and rows[0].get("gather_dot")):
            failures.append(f"bench: results csv rows {rows}")
        if a.accuracy != {"bsmr": 1.0, "gather_dot": 1.0}:
            failures.append(f"bench: analyze accuracy {a.accuracy}")
    return failures


# the parallel layer: 4 shards; the SUITE matrices at K=128 with their
# bench.py R4_BEST arms (delta 0.002, subpack 12, ph 32, fp32), the
# community run with the fused gathered tier
PAR_N = 4
PAR_ARMS = (("banded_mesh_32k", 0.3, "xla"), ("community_20k", 0.1, "fused"))
WORKER_TIMEOUT_S = 300


def mesh_devices(torch):
    """PAR_N cards where that many are visible, else PAR_N shards on the
    first card (run one after another), and how to say which."""
    if torch.cuda.device_count() >= PAR_N:
        return [f"cuda:{i}" for i in range(PAR_N)], f"{PAR_N} cards"
    return ["cuda:0"] * PAR_N, (
        f"{PAR_N} shards on cuda:0 ({torch.cuda.device_count()} card "
        f"visible: the shards run one after another)")


def sync_all(torch, devices):
    for d in sorted({str(d) for d in devices}):
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def time_mesh(torch, fn, args, devices):
    """(eager, replay) milliseconds per call: eager calls between CUDA
    events on the first device, which waits for the others after each
    call (distributed.join_devices), host enqueue included; and, where
    every shard is on one card, a replayed CUDA graph of one call (the
    device time, as ``sddmm_ms`` is timed), else None."""
    from bsmr_sddmm_tpu_torch.parallel.distributed import join_devices
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda, time_cuda_graph
    devs = sorted({torch.device(d) for d in devices}, key=str)
    with torch.cuda.device(devs[0]):
        eager, _ = time_cuda(join_devices(fn, devs), *args, iterations=10)
        replay = (time_cuda_graph(fn, *args, iterations=10)[0]
                  if len(devs) == 1 else None)
    return eager, replay


def say_ms(ms, ref_ms) -> str:
    """A path's (eager, replay) ms beside the single-device body's."""
    eager, replay = ms
    out = (f"{eager:.4f} ms a call eager (CUDA events, "
           f"{eager / ref_ms[0]:.2f}x single device)")
    if replay is None:
        return out + ", replay not measured (shards on several cards)"
    return out + (f", {replay:.4f} ms replayed graph "
                  f"({replay / ref_ms[1]:.2f}x single device)")


def counted_call(torch, fn, args, devices, results):
    """One call with the launch and collective counters set to 0 just
    before it: its result, launches (added to the kernels line) and
    collective counts."""
    from bsmr_sddmm_tpu_torch.parallel import collectives
    zero_launches()
    collectives.zero_counts()
    out = fn(*args)
    sync_all(torch, devices)
    return out, read_launches(results), collectives.read_counts()


def single_reference(torch, bt, dev, suite, refs, name, alpha, gb):
    """The single-device port on ``name`` at its arm (cached in
    ``refs``): config, reordering, plan, operands, the fp64 oracle, the
    body's CSR output and its (eager, replay) ms per call."""
    if name in refs:
        return refs[name]
    import numpy as np
    from bsmr_sddmm_tpu_torch.ops.sddmm import (device_plan,
                                                make_sddmm_body, sddmm_ref)
    csr = suite[name]
    cfg = bt.SddmmConfig(k=128, alpha=alpha, delta=0.002,
                         subpack_min_nnz=12, gathered_backend=gb)
    reord = bt.BsmrSddmm(csr, cfg, device=dev).reorder()
    plan = bt.pack_tiles(csr, reord, cfg)
    A = bt.make_dense(csr.rows, 128, seed=1337)
    B = bt.make_dense(128, csr.cols, seed=1338)
    Bt = np.ascontiguousarray(B.T)
    dp = device_plan(plan, dev)
    args = (torch.from_numpy(A).to(dev), torch.from_numpy(Bt).to(dev), dp)
    body = make_sddmm_body(plan, cfg, emit="csr")
    out = body(*args)
    refs[name] = dict(csr=csr, cfg=cfg, reord=reord, plan=plan, A=A, Bt=Bt,
                      dp=dp, args=args, expected=sddmm_ref(A, B, csr),
                      out=out, ms=time_mesh(torch, body, args, [dev]))
    return refs[name]


def hold(torch, label, vals, plain, ref, failures):
    """check_data against the fp64 oracle, and agreement (TOL fp32) with
    ``plain``, the same path built on the plain kernel versions
    (``backend="torch"``) on the same inputs, and with the single-device
    port's CSR output; returns the line part."""
    from bsmr_sddmm_tpu_torch.utils.checkdata import check_data
    res = check_data(ref["expected"], vals.float().cpu().numpy())
    if not res.passed:
        failures.append(f"{label}: check fail ({res.error_rate})")
    line = (f"check {'pass' if res.passed else 'fail'} (error rate "
            f"{res.error_rate})")
    for what, want in (("plain build", plain), ("single-device", ref["out"])):
        err, _, ok = compare(torch, vals, want, "float32")
        if not ok:
            failures.append(f"{label}: off the {what} output by {err}")
        line += (f"; vs {what} max_abs {err:.3e} "
                 f"({'ok' if ok else 'MISMATCH'} at {TOL['float32']})")
    return line


def sharded_phase(torch, bt, dev, suite, results, picks, refs):
    """Phase 12: make_sharded_sddmm over a PAR_N-shard mesh at K=128 on
    banded_mesh_32k (emit="csr" with B replicated and b-sharded,
    emit="rphm" reassembled through sharded_rphm_to_csr, and the
    single-device body's emit="csr_scatter") and community_20k (emit="csr"
    with the fused gathered tier): each against the fp64 oracle, its
    plain build (backend="torch") and the single-device port's output,
    with its launches and collectives per call and its ms per call by CUDA
    events."""
    from bsmr_sddmm_tpu_torch.ops.sddmm import make_sddmm_body
    from bsmr_sddmm_tpu_torch.parallel import (make_mesh, make_sharded_sddmm,
                                               shard_operands,
                                               sharded_rphm_to_csr)
    devices, where = mesh_devices(torch)
    say(f"[sharded] mesh: {where}")
    mesh = make_mesh(devices=devices)
    failures = []
    for name, alpha, gb in PAR_ARMS:
        ref = single_reference(torch, bt, dev, suite, refs, name, alpha, gb)
        csr, cfg, reord = ref["csr"], ref["cfg"], ref["reord"]
        fixed = picks.get(name, {}).get("fixed arm")
        say(f"[sharded] {name} K=128 alpha={alpha} delta=0.002 subpack 12 "
            f"gathered={gb}: single-device csr body {ref['ms'][0]:.4f} ms a "
            f"call eager (CUDA events), {ref['ms'][1]:.4f} ms replayed "
            f"graph" + (f"; [main] sddmm_ms {fixed[3]:.4f} (rphm, graph "
                        f"replay)" if fixed and gb == "xla" else ""))
        runs = (("csr", False), ("csr b_sharded", True), ("rphm", False),
                ("csr_scatter", None)) if gb == "xla" else (("csr", False),)
        for label, b_sharded in runs:
            run = f"sharded {name} {label}"
            if label == "csr_scatter":
                plan = ref["plan"]
                fn, plain_fn = (make_sddmm_body(plan, cfg, b,
                                                emit="csr_scatter")
                                for b in (None, "torch"))
                args, devs, shards, p0 = ref["args"], [dev], 1, plan
            else:
                emit = "rphm" if label == "rphm" else "csr"
                fn, dplan, plans = make_sharded_sddmm(
                    csr, reord, cfg, mesh, b_sharded=b_sharded, emit=emit)
                plain_fn = make_sharded_sddmm(
                    csr, reord, cfg, mesh, b_sharded=b_sharded, emit=emit,
                    backend="torch")[0]
                A_d, Bt_d = shard_operands(ref["A"], ref["Bt"], mesh,
                                           b_sharded=b_sharded)
                args, devs, shards = (A_d, Bt_d, dplan), devices, PAR_N
                p0 = plans[0]

            def values(out):
                if label == "rphm":
                    cmap = torch.from_numpy(sharded_rphm_to_csr(plans)).to(dev)
                    return torch.cat([torch.cat([t.reshape(-1).to(dev)
                                                 for t in tier])
                                      for tier in out]).index_select(0, cmap)
                return out[:csr.nnz] if label == "csr_scatter" else out
            t0 = time.perf_counter()
            out, launches, counts = counted_call(torch, fn, args, devs,
                                                 results)
            line = hold(torch, run, values(out), values(plain_fn(*args)),
                        ref, failures)
            ms = time_mesh(torch, fn, args, devs)
            say(f"[sharded]   {label}: {line}; {say_ms(ms, ref['ms'])}; "
                f"launches "
                f"{launches}; collectives {counts}; wall "
                f"{time.perf_counter() - t0:.1f} s")
            # a kernel launches on every shard whose (common) tier shape
            # is not empty
            fused = (gb == "fused" and p0.g_panel.shape[0] > 0
                     and p0.g_groups is None)
            want = {"bsr_dense": shards * bool(p0.tile_panel.shape[0]),
                    "subpack": shards * bool(p0.sp_panel.shape[0]),
                    "fused_gathered": shards * fused}
            for kname, n in want.items():
                if launches[kname] != n:
                    failures.append(f"{run}: {kname} launched "
                                    f"{launches[kname]} times, not {n}")
            if counts["all_gather"] != int(bool(b_sharded)):
                failures.append(f"{run}: all_gather {counts['all_gather']}")
    return failures


def ring_phase(torch, bt, dev, suite, results, refs):
    """Phase 13: make_ring_sddmm(emit="csr") on banded_mesh_32k and
    community_20k at K=128 over PAR_N shards: check_data, agreement with
    its plain build and the single-device output, bsr_dense PAR_N^2
    launches a call (and dense_tile where the plan has gathered tiles),
    PAR_N - 1 hops per shard and no all-gather."""
    from bsmr_sddmm_tpu_torch.parallel import (make_mesh, make_ring_sddmm,
                                               ring_operands)
    devices, where = mesh_devices(torch)
    mesh = make_mesh(devices=devices)
    n, failures = PAR_N, []
    for name, alpha, gb in PAR_ARMS:
        ref = single_reference(torch, bt, dev, suite, refs, name, alpha, gb)
        t0 = time.perf_counter()
        fn, plan = make_ring_sddmm(ref["csr"], ref["reord"], ref["cfg"],
                                   mesh, emit="csr")
        plain_fn = make_ring_sddmm(ref["csr"], ref["reord"], ref["cfg"],
                                   mesh, emit="csr", backend="torch")[0]
        args = ring_operands(ref["A"], ref["Bt"], plan, mesh)
        out, launches, counts = counted_call(torch, fn, args, devices,
                                             results)
        run = f"ring {name}"
        line = hold(torch, run, out, plain_fn(*args), ref, failures)
        ms = time_mesh(torch, fn, args, devices)
        Tg = plan.tiles_g_per_group
        say(f"[ring] {name} K=128 n={n} ({where}): {line}; "
            f"{say_ms(ms, ref['ms'])}; w "
            f"{plan.w}, Td {plan.tiles_per_group}, Tg {Tg} "
            f"({plan.num_gathered} real), E {plan.res_per_group}; launches "
            f"{launches}; collectives {counts}; wall "
            f"{time.perf_counter() - t0:.1f} s")
        want = {"bsr_dense": n * n, "dense_tile": n * n if Tg else 0,
                "subpack": 0, "fused_gathered": 0}
        for kname, k in want.items():
            if launches[kname] != k:
                failures.append(f"{run}: {kname} launched {launches[kname]} "
                                f"times, not {k}")
        if (counts["ring_shift"], counts["shard_hops"],
                counts["all_gather"]) != (n - 1, n * (n - 1), 0):
            failures.append(f"{run}: collectives {counts}")
    return failures


def weak_phase(torch, results):
    """Phase 14: sddmm_weak_scaling([1, 2, 4]) at its defaults (8192 rows
    and 500 000 nnz a shard, 8192 columns, K=128, band 256, ph 32): the
    shards of a count share one shape, each shard's output slots stay
    within 2x of one shard's, the replicated-B rphm path runs no
    collective, and ms a call by CUDA events."""
    from bsmr_sddmm_tpu_torch.parallel import collectives, distributed
    devices, where = mesh_devices(torch)
    zero_launches()
    collectives.zero_counts()
    res = distributed.sddmm_weak_scaling([1, 2, PAR_N], devices=devices)
    launches = read_launches(results)
    counts = collectives.read_counts()
    one_card = len(set(devices)) == 1
    failures = [] if not any(counts.values()) else [
        f"weak: collectives on the rphm path {counts}"]

    def slots(shape):   # (T + Tp + Tg) tiles of 32 x 128, E residual slots
        T, Tp, Tg, E, _ = shape
        return (T + Tp + Tg) * 32 * 128 + E

    base = slots(res[1]["shard_shapes"][0])
    for n, rec in sorted(res.items()):
        shapes = rec["shard_shapes"]
        say(f"[weak] n={n} ({where}): {rec['ms']:.4f} ms a call (CUDA "
            f"events), {rec['nnz_per_s']:.4g} nnz/s, efficiency "
            f"{rec['efficiency']:.3f}"
            + (" (serial on one card: not a scaling figure)" if one_card
               else "")
            + f"; shard shapes (T, Tp, Tg, E, panels) {shapes[0]}, output "
              f"slots {slots(shapes[0])} ({slots(shapes[0]) / base:.2f}x "
              f"n=1)")
        if len(set(shapes)) != 1:
            failures.append(f"weak: n={n} shards differ in shape {shapes}")
        if slots(shapes[0]) > 2 * base:
            failures.append(f"weak: n={n} shard slots {slots(shapes[0])} "
                            f"above 2x n=1's {base}")
    say(f"[weak] launches {launches}; collectives {counts}")
    if launches["bsr_dense"] <= 0:
        failures.append("weak: bsr_dense never launched")
    return failures


def run_workers(backend, devices, args=("--matrix", "banded_mesh_32k")):
    """Two worker processes (python -m bsmr_sddmm_tpu_torch.parallel.worker)
    on ``backend``, process i on ``devices[i]``, with the worker's
    arguments ``args`` (the sharded SDDMM on banded_mesh_32k by default);
    their JSON lines, and the failures. Both are stopped before it
    returns."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(HERE), os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.parallel.worker", str(pid), "2",
         port, "--device", devices[pid], "--backend", backend, *args],
        cwd=str(HERE), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    recs, failures = [], []
    try:
        for pid, proc in enumerate(procs):
            out, err = proc.communicate(timeout=WORKER_TIMEOUT_S)
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            if proc.returncode != 0 or not lines:
                failures.append(f"multihost {backend}: worker {pid} exit "
                                f"{proc.returncode}: {out[-2000:]} "
                                f"{err[-4000:]}")
                continue
            recs.append(json.loads(lines[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return recs, failures


def multihost_phase(torch):
    """Phase 15: two worker processes, each owning 2 shards of one 4-shard
    mesh, on banded_mesh_32k at K=128: on gloo with both on cuda:0 (CUDA
    tensors staged through host memory), and on nccl with a card each
    where 2 cards are visible. Both lines must read check and ring_check
    pass, 4 shards, 2 processes and one plan hash."""
    failures = []
    arms = [("gloo", ["cuda:0", "cuda:0"])]
    if torch.cuda.device_count() >= 2:
        arms.append(("nccl", ["cuda:0", "cuda:1"]))
    for backend, devices in arms:
        t0 = time.perf_counter()
        recs, found = run_workers(backend, devices)
        failures += found
        for rec in recs:
            say(f"[multihost] {backend}: {json.dumps(rec)}")
            ok = (rec["check"], rec["ring_check"], rec["global_devices"],
                  rec["num_processes"], rec["shards"]) == \
                ("pass", "pass", 4, 2, 4)
            sc, rc = rec["sharded_counts"], rec["ring_counts"]
            ok = ok and (sc["all_gather"], rc["ring_shift"],
                         rc["all_gather"]) == (1, 3, 0)
            ok = ok and rec["host_staged"] == (backend == "gloo")
            ok = ok and sc["bsr_dense"] == 2 and rc["bsr_dense"] == 8
            if not ok:
                failures.append(f"multihost {backend}: {rec}")
        if len(recs) == 2 and recs[0]["plan_hash"] != recs[1]["plan_hash"]:
            failures.append(f"multihost {backend}: plan hashes differ")
        say(f"[multihost] {backend} on {devices}: "
            + ("host-staged (gloo moves host buffers); " if backend ==
               "gloo" else "") + f"wall {time.perf_counter() - t0:.1f} s")
    if len(arms) == 1:
        say("[multihost] nccl: NOT RUN on this machine "
            f"({torch.cuda.device_count()} card visible; NCCL needs a card "
            "per process)")
    return failures


#: the two-process steps' losses against the one-process steps': the
#: forward sums each row from one shard only; k's and v's gradients are
#: summed in another order, and index_add on the card in no fixed order
SHARDED_LOSS_RTOL = 1e-5


def time_steps(step, opt, *args):
    """A warm-up step, then two steps timed by CUDA events
    (``utils.timing.time_cuda``): the three losses and the ms a step of
    the last two."""
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda
    losses = []
    ms, _ = time_cuda(lambda: losses.append(step(opt, *args)), iterations=2)
    return [float(x) for x in losses], ms


def train_sharded_phase(torch, dev, results, smi):
    """Phase 16: both model families' Adam step over a PAR_N-shard mesh
    (``make_forward(..., mesh=)``) at full width: the graph transformer of
    [train] on community_20k (its inputs ``parallel.worker.
    train_problem``'s) and the sparse transformer of SEQ_MODEL. Logits and
    every gradient against the same step on the plain versions
    (backend="torch") and against the single-device kernel step;
    ``bsr_dense`` and ``subpack`` launched once per shard, head and layer
    of every forward; three Adam steps that lower the loss, ms a step by
    CUDA events beside the single-device step's, launches per step and a
    torch.profiler split; then two ``parallel.worker --train`` processes
    on gloo (cuda:0 twice) whose losses and parameter hashes agree and
    whose losses equal the one-process 4-shard steps'."""
    import numpy as np
    from bsmr_sddmm_tpu_torch.config import SddmmConfig
    from bsmr_sddmm_tpu_torch.models import graph_transformer as gt
    from bsmr_sddmm_tpu_torch.models import sparse_transformer as st
    from bsmr_sddmm_tpu_torch.parallel import collectives, make_mesh, worker
    devices, where = mesh_devices(torch)
    mesh = make_mesh(devices=devices)
    say(f"[train-sharded] mesh: {where}")
    failures = []
    csr, gcfg, gmodel, X, labels = worker.train_problem("community_20k")
    if (dict(num_nodes=gmodel.num_nodes, feature_dim=gmodel.feature_dim,
             head_dim=gmodel.head_dim) != GRAPH_MODEL
            or gcfg != SddmmConfig(**GRAPH_CFG)):
        failures.append(f"train-sharded: the worker's problem {gmodel} "
                        f"{gcfg} is not [train]'s")
    smodel = st.SparseTransformer(**SEQ_MODEL)
    scfg = SddmmConfig(k=128, delta=0.05)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, smodel.vocab_size, smodel.seq_len)).to(dev)
    graph_batch = (torch.from_numpy(X).to(dev),
                   torch.from_numpy(labels).to(dev))
    fams = (("graph", gt, gmodel, worker.TRAIN_LR, graph_batch,
             lambda cfg, **kw: gt.make_forward(gmodel, csr, cfg, **kw),
             gcfg),
            ("sparse", st, smodel, 1e-3, (tokens,),
             lambda cfg, **kw: st.make_forward(smodel, config=cfg,
                                               **SEQ_MASK, **kw), scfg))
    graph_losses = None
    for name, mod, model, lr, batch, build, cfg in fams:
        t0 = time.perf_counter()
        net, dplan, plans = build(cfg, mesh=mesh)
        nets = {"plain build": build(cfg.replace(backend="torch"),
                                     mesh=mesh)[:2],
                "single-device kernel step": build(cfg, device=dev)[:2]}
        p0 = plans[0]
        say(f"[train-sharded] {name} transformer ({model.num_heads} heads, "
            f"{model.num_layers} layers, lr {lr}): {PAR_N} shard plans of "
            f"(T, Tp, Tg, E) = ({p0.tile_panel.shape[0]}, "
            f"{p0.sp_panel.shape[0]}, {p0.g_panel.shape[0]}, "
            f"{p0.res_arow.shape[0]}) each, G={p0.fat_group}; three nets "
            f"built in {time.perf_counter() - t0:.1f} s")
        per_forward = PAR_N * model.num_heads * model.num_layers
        want = {k: per_forward * bool(n) for k, n in (
            ("bsr_dense", p0.tile_panel.shape[0]),
            ("subpack", p0.sp_panel.shape[0]))}
        zero_launches()
        collectives.zero_counts()
        with torch.no_grad():
            logits = net(batch[0], dplan)
        mod.loss_fn(net, *batch, dplan).backward()
        torch.cuda.synchronize()
        launches = read_launches(results)
        counts = collectives.read_counts()
        say(f"[train-sharded]   a forward, and a forward and backward: "
            f"launches {launches} (want {want} a forward: {PAR_N} shards x "
            f"{model.num_heads} heads x {model.num_layers} layers); "
            f"collectives {counts}")
        failures += [f"train-sharded {name}: {k} launched {launches[k]} "
                     f"times, not {2 * n}" for k, n in want.items()
                     if launches[k] != 2 * n]
        if not all(want.values()):
            failures.append(f"train-sharded {name}: a tier kernel has no "
                            f"work ({want})")
        for ref, (m, dp) in nets.items():
            with torch.no_grad():
                err, ok = max_err(torch, logits, m(batch[0], dp))
            mod.loss_fn(m, *batch, dp).backward()
            grads = grad_errors(net, m)
            worst = max(grads, key=lambda g: g[1])
            good = all(g[2] for g in grads)
            say(f"[train-sharded]   vs the {ref}: logits max_abs {err:.3e} "
                f"({'ok' if ok else 'MISMATCH'} at {LOGIT_TOL}); gradients "
                f"of {len(grads)} parameters, largest max_abs "
                f"{worst[1]:.3e} ({worst[0]}), "
                f"{'all ok' if good else 'MISMATCH'} at rtol {GRAD_RTOL} + "
                f"atol {GRAD_ATOL_SCALE} x max|g|")
            if not ok:
                failures.append(f"train-sharded {name}: logits off the "
                                f"{ref} by {err:.3e}")
            failures += [f"train-sharded {name}: gradient of {n} off the "
                         f"{ref} by {e:.3e}" for n, e, g in grads if not g]
        single, sdp = nets.pop("single-device kernel step")
        del nets, logits
        zero_launches()
        opt_init, step = mod.make_train_step(model, net, lr)
        opt = opt_init()
        losses, step_ms = time_steps(step, opt, *batch, dplan)
        launches = read_launches(results)
        split, _ = step_split(torch, step, opt, *batch, dplan)
        opt_init, step1 = mod.make_train_step(model, single, lr)
        losses1, single_ms = time_steps(step1, opt_init(), *batch, sdp)
        say(f"[train-sharded]   Adam steps: losses "
            f"{[round(x, 5) for x in losses]} (single device "
            f"{[round(x, 5) for x in losses1]}); {step_ms:.3f} ms a step "
            f"(CUDA events, steps 2-3; {step_ms / single_ms:.2f}x the "
            f"single-device step's {single_ms:.3f} ms, same call); launches "
            f"a step {({k: n / 3 for k, n in launches.items()})}; {smi}")
        say_split(f"{name} transformer over {PAR_N} shards", split, smi,
                  "train-sharded")
        if not (all(math.isfinite(x) for x in losses)
                and losses[2] < losses[0]):
            failures.append(f"train-sharded {name}: losses {losses}")
        failures += [f"train-sharded {name} steps: {k} launched "
                     f"{launches[k]} times, not {3 * n}"
                     for k, n in want.items() if launches[k] != 3 * n]
        if name == "graph":
            graph_losses = losses
        del net, single, opt
    # two processes, 2 shards each, on cuda:0 over gloo
    t0 = time.perf_counter()
    recs, found = run_workers("gloo", ["cuda:0", "cuda:0"],
                              ("--train", "--matrix", "community_20k"))
    failures += [f"train-sharded {f}" for f in found]
    for rec in recs:
        say(f"[train-sharded] worker --train: {json.dumps(rec)}")
        ok = (rec["check"], rec["shards"], rec["num_processes"],
              rec["host_staged"]) == ("pass", 4, 2, True)
        c = rec["counts"]
        ok = ok and c["all_reduce"] == 2 * c["to_shards"] > 0
        ok = ok and c["cross_process_bytes"] > 0 and c["bsr_dense"] > 0
        ok = ok and np.allclose(rec["losses"], graph_losses,
                                rtol=SHARDED_LOSS_RTOL, atol=0)
        if not ok:
            failures.append(f"train-sharded worker: {rec}")
    if len(recs) == 2 and (recs[0]["param_hash"] != recs[1]["param_hash"]
                           or recs[0]["losses"] != recs[1]["losses"]):
        failures.append("train-sharded worker: the processes differ")
    say(f"[train-sharded] worker --train on cuda:0 twice over gloo: losses "
        f"vs the one-process {PAR_N}-shard steps "
        f"{graph_losses} at rtol {SHARDED_LOSS_RTOL}; wall "
        f"{time.perf_counter() - t0:.1f} s")
    return failures


#: [graft]: bsmr_sddmm_tpu_torch.graft_entry, the port of
#: __graft_entry__.py: entry()'s forward, dryrun_multichip(GRAFT_TINY_N) on
#: its tiny problem with the shards on the visible cards (all on cuda:0 on
#: a one-card machine), and dryrun_multichip(PAR_N) at full width on
#: community_20k at [train-sharded]'s arm (GRAPH_CFG: bench.py's R4_BEST
#: alpha 0.1, delta 0.002, subpack 12, ph 32), so head_dim 128
GRAFT_TINY_N = 8
#: the kernels a dry run must launch: bsr_dense and subpack in the shard
#: bodies and heads, bsr_dense and dense_tile in the ring; entry()'s
#: single-device bsr forward has no ring and runs the first two
GRAFT_KERNELS = ("bsr_dense", "subpack", "dense_tile")


def graft_phase(torch, dev, suite, results, smi):
    """Phase 17: the graft entry points on the card. entry()'s forward
    and each dry run (dryrun_multichip(GRAFT_TINY_N) on the tiny problem,
    dryrun_multichip(PAR_N) at full width) against the same path built on
    the plain versions (problem=(csr, cfg with backend="torch")) at TOL:
    the logits, the loss and every SDDMM output (each of which the dry run
    holds to the fp64 oracle by check_data, and raises where one fails);
    the launches of the GRAFT_KERNELS each runs, the ms of its one call
    per part, its wall time."""
    from bsmr_sddmm_tpu_torch import graft_entry
    from bsmr_sddmm_tpu_torch.config import SddmmConfig
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda
    failures = []
    tiny = graft_entry._tiny_problem()

    def plain(problem):
        csr, cfg = problem
        return csr, cfg.replace(backend="torch")

    # 1. entry(): the forward through the hand kernels, and on the plain
    # versions
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    zero_launches()
    with torch.no_grad():
        logits = fn(*args)
    torch.cuda.synchronize()
    launches = read_launches(results)
    pfn, pargs = graft_entry.entry(problem=plain(tiny))
    with torch.no_grad():
        err, _, ok = compare(torch, logits, pfn(*pargs), "float32")
        ms, _ = time_cuda(lambda: fn(*args))
    shape = (tiny[0].rows, graft_entry.NUM_CLASSES)
    say(f"[graft] entry(): logits {tuple(logits.shape)} (want {shape}) vs "
        f"the plain build max_abs {err:.3e} ({'ok' if ok else 'MISMATCH'} "
        f"at {TOL['float32']}); {ms:.4f} ms a forward (CUDA events, 10 "
        f"calls after a warm-up); launches {launches}; wall "
        f"{time.perf_counter() - t0:.1f} s; {smi}")
    if not ok or tuple(logits.shape) != shape:
        failures.append(f"graft entry(): logits {tuple(logits.shape)} off "
                        f"the plain build by {err:.3e}")
    failures += [f"graft entry(): {k} never launched"
                 for k in GRAFT_KERNELS[:2] if launches[k] <= 0]

    # 2-3. the dry runs, each against its plain build
    full = (suite["community_20k"], SddmmConfig(**GRAPH_CFG))
    for label, n, problem in (("tiny", GRAFT_TINY_N, None),
                              ("community_20k K=128", PAR_N, full)):
        run = f"graft dryrun_multichip({n}) {label}"
        t0 = time.perf_counter()
        try:
            zero_launches()
            got = graft_entry.dryrun_multichip(n, problem=problem)
            launches = read_launches(results)
            want = graft_entry.dryrun_multichip(n, problem=plain(
                problem or tiny))
        except Exception as e:   # a failed check raises in the dry run
            failures.append(f"{run}: {type(e).__name__}: {e}")
            continue
        tol = TOL["float32"]
        loss_ok = (math.isfinite(got["loss"]) and abs(
            got["loss"] - want["loss"]) <= tol["atol"] + tol["rtol"] * abs(
                want["loss"]))
        errs = {}
        for key, vals in got["outputs"].items():
            err, _, ok = compare(torch, torch.from_numpy(vals),
                                 torch.from_numpy(want["outputs"][key]),
                                 "float32")
            errs[key] = err
            if not ok:
                failures.append(f"{run}: {key} off the plain build by "
                                f"{err:.3e}")
        say(f"[graft] dryrun_multichip({n}) {label} on "
            f"{sorted(set(got['devices']))}: loss {got['loss']:.6f} vs the "
            f"plain build's {want['loss']:.6f} "
            f"({'ok' if loss_ok else 'MISMATCH'}); check_data error rates "
            f"{got['error_rates']}; outputs vs the plain build max_abs "
            f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } at "
            f"{tol}; ms (one call each, host wall, cards synchronised) "
            f"{ {k: round(v, 3) for k, v in got['ms'].items()} }; launches "
            f"{launches}; wall {time.perf_counter() - t0:.1f} s (both "
            f"builds); {smi}")
        if not loss_ok:
            failures.append(f"{run}: loss {got['loss']} vs the plain "
                            f"build's {want['loss']}")
        failures += [f"{run}: {k} never launched" for k in GRAFT_KERNELS
                     if launches[k] <= 0]
    return failures


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
    from bsmr_sddmm_tpu_torch.utils.compilecache import enable_compile_cache
    # the plain versions are the reference: full fp32 matmuls, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say(f"[device] {kind}; count {torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    say(f"[device] nvidia-smi: {smi}")

    # the kernel build cache under build/torch_kernels/ of this checkout: a
    # second run of the same sources loads the library the first built
    cache_dir = enable_compile_cache()
    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info
    how = ("built now" if info["compiled"]
           else "reused the library an earlier run built")
    say(f"[build] {info['path']}: compiled={info['compiled']} nvcc "
        f"{info['seconds']:.1f} s (load {time.perf_counter() - t0:.1f} s; "
        f"kernel build cache {cache_dir}: {how})")
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
                          library_ms=None, one_pass=None)
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
    failures += timed("main settings", settings_path, torch, bt, dev, suite,
                      results, smi)
    if failures:
        fail(f"main path: {failures}")
    busy_ms = {}
    timed("profile", profile_phase, torch, bt, dev, suite["banded_mesh_32k"],
          busy_ms)
    failures = check_headline(picks, busy_ms)
    failures += timed("autotune", autotune_phase, bt, dev, suite, results,
                      picks)
    failures += timed("calibrate", calibrate_phase, torch, bt, dev, suite,
                      smi, results, picks)
    failures += timed("arms", arms_phase, torch, bt, dev, suite, smi,
                      results)
    failures += timed("dense", dense_phase, bt, dev, results)
    failures += timed("cli", run_cli, bt, suite["community_20k"])
    failures += timed("train", train_phase, torch, bt, dev,
                      suite["community_20k"], results, smi)
    failures += timed("batched", batched_phase, torch, bt, dev,
                      suite["community_20k"], results)
    refs = {}
    failures += timed("sharded", sharded_phase, torch, bt, dev, suite,
                      results, picks, refs)
    failures += timed("ring", ring_phase, torch, bt, dev, suite, results,
                      refs)
    refs.clear()
    failures += timed("weak", weak_phase, torch, results)
    failures += timed("multihost", multihost_phase, torch)
    failures += timed("train-sharded", train_sharded_phase, torch, dev,
                      results, smi)
    failures += timed("graft", graft_phase, torch, dev, suite, results, smi)
    failures += timed("bench", bench_phase, torch, bt, dev, suite, results)
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
