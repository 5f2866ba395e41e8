#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bsmr_sddmm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card. Phases:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc compiles csrc/*.cu for sm_90a (into build/torch_kernels/);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes of plans packed from the SUITE matrix banded_mesh_32k at
   K=128 and K=32 (fp32 and fp16 output), with max errors and CUDA-event
   times of both: bsr_dense and subpack on bsr plans (the plan's fat group
   G and G=1), dense_tile and fused_gathered on col_mode="reorder" plans
   (alpha 0.3, delta 0.05);
4. main path: BsmrSddmm(csr, cfg).benchmark(A, B, validate=True) at K=128
   on banded_mesh_32k and community_20k: the bsr path (and once with fp16
   output), the reorder path with the fused gathered tier (once with
   tier_times), and the bsr path with the fused gathered tier. Every run
   must pass check_data against the fp64 oracle, and the launch counters
   of the kernels it runs, set to 0 just before it, must rise during it;
5. CLI: python -m bsmr_sddmm_tpu_torch.cli -f <suite matrix .mtx> -k 128
   -a 0.3 -d 0.002 --validate exits 0, and so does the run with
   --col-mode reorder -d 0.05 --evaluate --tier-times --reorder-cache
   (BSMR_CACHE_DIR in a temporary directory).

The last lines are the nvidia-smi line, a JSON line with one record per
kernel, and {"ok": true, "device": {...}}. Any failure, or no CUDA device,
exits non-zero before them. Imports nothing of JAX.
"""

from __future__ import annotations

import json
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
# fp32: both sides accumulate K <= 256 products of values in [0, 2) in
# fp32 and differ only in summation order. fp16: each side rounds its fp32
# sum to fp16 once, so they differ by at most one fp16 ulp (rel 2^-10),
# which is the check_data tolerance (abs 1e-5 OR rel 1e-3).
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


def check_kernels(torch, bt, dev, csr, results):
    """Phase 3: each kernel vs its plain version at the plans' shapes."""
    from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
    from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda
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
            cases = [("bsr_dense", dk.bsr_dense, dk.bsr_dense_plain,
                      (A_panels, Bt, dp.tile_panel, dp.tile_src),
                      dict(fat_group=plan.fat_group,
                           block_width=plan.block_width))]
            if fat != 1 and plan.num_packed:
                Bt2 = Bt.index_select(0, dp.sp_colperm)
                cases.append(("subpack", dk.subpack, dk.subpack_plain,
                              (A_panels, Bt2, dp.sp_panel, dp.sp_sub),
                              dict(subblock_width=plan.subblock_width)))
            for name, kern, plain, args, kw in cases:
                for od in ("float32", "float16"):
                    dt = getattr(torch, od)
                    got = kern(*args, out_dtype=dt, **kw)
                    want = plain(*args, out_dtype=dt, **kw)
                    torch.cuda.synchronize()
                    max_abs, max_rel, ok = compare(torch, got, want, od)
                    ms, _ = time_cuda(lambda: kern(*args, out_dtype=dt, **kw),
                                      iterations=20)
                    plain_ms, _ = time_cuda(
                        lambda: plain(*args, out_dtype=dt, **kw),
                        iterations=20)
                    say(f"[kernels]   {name} G={kw.get('fat_group', '-')} "
                        f"K={k} {od} out={tuple(got.shape)}: max_abs "
                        f"{max_abs:.3e} max_rel {max_rel:.3e} "
                        f"{'ok' if ok else 'MISMATCH'}; kernel {ms:.4f} ms, "
                        f"plain {plain_ms:.4f} ms")
                    if not ok:
                        failures.append(f"{name} K={k} G={plan.fat_group} "
                                        f"{od}")
                    rec = results[name]
                    if od == "float32":
                        rec["max_abs_err"] = max(rec["max_abs_err"], max_abs)
                    if (k, fat, od) == (128, 32, "float32"):
                        rec.update(ms=ms, plain_ms=plain_ms)
            del A_panels, dp
    return failures


def check_gathered_kernels(torch, bt, dev, csr, results):
    """Phase 3, second part: dense_tile and fused_gathered vs their plain
    version at the shapes of banded_mesh_32k reorder plans."""
    from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
    from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda
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
        cases = (("dense_tile", dk.dense_tile, dk.dense_tile_plain,
                  (A_panels, Bt, dp.tile_panel, dp.tile_src)),
                 ("fused_gathered", dk.fused_gathered,
                  dk.fused_gathered_plain,
                  (A_panels, Bt, dp.g_panel, dp.g_cols)))
        for name, kern, plain, args in cases:
            for od in ("float32", "float16"):
                dt = getattr(torch, od)
                got = kern(*args, out_dtype=dt)
                want = plain(*args, out_dtype=dt)
                torch.cuda.synchronize()
                max_abs, max_rel, ok = compare(torch, got, want, od)
                ms, _ = time_cuda(lambda: kern(*args, out_dtype=dt),
                                  iterations=20)
                plain_ms, _ = time_cuda(lambda: plain(*args, out_dtype=dt),
                                        iterations=20)
                say(f"[kernels]   {name} K={k} {od} out={tuple(got.shape)}: "
                    f"max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
                    f"{'ok' if ok else 'MISMATCH'}; kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms")
                if not ok:
                    failures.append(f"{name} K={k} {od}")
                rec = results[name]
                if od == "float32":
                    rec["max_abs_err"] = max(rec["max_abs_err"], max_abs)
                if (k, od) == (128, "float32"):
                    rec.update(ms=ms, plain_ms=plain_ms)
        del A_panels, dp
    return failures


def main_path(bt, dev, suite, results):
    """Phase 4: the user's entry point on the suite matrices."""
    from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
    failures = []
    for name, alpha, delta, od, mode, gb, tiers, expect in MAIN:
        csr = suite[name]
        cfg = bt.SddmmConfig(k=128, alpha=alpha, delta=delta,
                             subpack_min_nnz=12, out_dtype=od,
                             col_mode=mode, gathered_backend=gb)
        A = bt.make_dense(csr.rows, 128, seed=1337)
        B = bt.make_dense(128, csr.cols, seed=1338)
        for kname in KERNELS:
            getattr(dk, kname).launches = 0
        t0 = time.perf_counter()
        log = bt.BsmrSddmm(csr, cfg, device=dev).benchmark(
            A, B, validate=True, tier_times=tiers, file=name)
        wall = time.perf_counter() - t0
        launches = {kname: getattr(dk, kname).launches for kname in KERNELS}
        for kname, n in launches.items():
            results[kname]["launches"] += n
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
    return failures


CLI_RUNS = ((["-a", "0.3", "-d", "0.002", "--validate"], ()),
            (["-a", "0.3", "-d", "0.05", "--col-mode", "reorder",
              "--evaluate", "--tier-times", "--reorder-cache", "--validate"],
             ("[denseBlockGain", "[tier_dense_ms",
              "[tier_overlap_efficiency")))


def run_cli(bt, csr) -> list:
    """Phase 5: the console entry point on a suite matrix in a .mtx."""
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "community_20k.mtx")
        bt.formats.save_mtx(path, csr)
        env = dict(os.environ, BSMR_CACHE_DIR=os.path.join(tmp, "cache"))
        for flags, want in CLI_RUNS:
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
    return failures


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
            f"smem, spills: {'YES' if spills else 'none'}")

    t0 = time.perf_counter()
    suite = {name: gen() for name, gen in datasets.SUITE
             if name in ("banded_mesh_32k", "community_20k")}
    say(f"[data] suite matrices in {time.perf_counter() - t0:.1f} s")

    results = {name: dict(name=name, route="cuda", **meta, launches=0,
                          max_abs_err=0.0, ms=None, plain_ms=None)
               for name, meta in KERNELS.items()}
    dev = torch.device("cuda")
    failures = check_kernels(torch, bt, dev, suite["banded_mesh_32k"],
                             results)
    failures += check_gathered_kernels(torch, bt, dev,
                                       suite["banded_mesh_32k"], results)
    if failures:
        fail(f"kernels disagree with their plain versions: {failures}")
    failures = main_path(bt, dev, suite, results)
    if failures:
        fail(f"main path: {failures}")
    failures = run_cli(bt, suite["community_20k"])
    if failures:
        fail(f"cli: {failures}")
    if "jax" in sys.modules:
        fail("jax was imported")

    say(smi)
    say(json.dumps({"kernels": list(results.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
