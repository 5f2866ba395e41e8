#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bsmr_sddmm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card. Phases:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc compiles csrc/*.cu for sm_90a (into build/torch_kernels/);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes of plans packed from the SUITE matrix banded_mesh_32k at
   K=128 and K=32 (the plan's fat group G and G=1; fp32 and fp16 output),
   with max errors and CUDA-event times of both;
4. main path: BsmrSddmm(csr, cfg).benchmark(A, B, validate=True) on
   banded_mesh_32k and community_20k at K=128 (and once with fp16 output):
   the result must pass check_data against the fp64 oracle, and both
   kernels' launch counters must rise during the run;
5. CLI: python -m bsmr_sddmm_tpu_torch.cli -f <suite matrix .mtx> -k 128
   -a 0.3 -d 0.002 --validate exits 0.

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
}
# the main path's cells: SUITE matrix, alpha; delta 0.002 and subpack 12
# (the JAX package's best arms for them, bench.py R4_BEST), K=128, ph=32
MAIN = (("banded_mesh_32k", 0.3, "float32"),
        ("community_20k", 0.1, "float32"),
        ("banded_mesh_32k", 0.3, "float16"))


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


def main_path(bt, dev, suite, results):
    """Phase 4: the user's entry point on the suite matrices."""
    from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
    failures = []
    for name, alpha, od in MAIN:
        csr = suite[name]
        cfg = bt.SddmmConfig(k=128, alpha=alpha, delta=0.002,
                             subpack_min_nnz=12, out_dtype=od)
        A = bt.make_dense(csr.rows, 128, seed=1337)
        B = bt.make_dense(128, csr.cols, seed=1338)
        dk.bsr_dense.launches = dk.subpack.launches = 0
        t0 = time.perf_counter()
        log = bt.BsmrSddmm(csr, cfg, device=dev).benchmark(
            A, B, validate=True, file=name)
        wall = time.perf_counter() - t0
        launches = {"bsr_dense": dk.bsr_dense.launches,
                    "subpack": dk.subpack.launches}
        for kname, n in launches.items():
            results[kname]["launches"] += n
        say(f"[main] {name} K=128 alpha={alpha} delta=0.002 {od}: "
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
            f"device {log.device}")
        if log.check_result != "pass":
            failures.append(f"{name} {od}: check {log.check_result}")
        for kname, n in launches.items():
            if n <= 0:
                failures.append(f"{name} {od}: {kname} never launched")
    return failures


def run_cli(bt, csr) -> list:
    """Phase 5: the console entry point on a suite matrix in a .mtx."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "community_20k.mtx")
        bt.formats.save_mtx(path, csr)
        cmd = [sys.executable, "-m", f"{PKG}.cli", "-f", path, "-k", "128",
               "-a", "0.3", "-d", "0.002", "--validate"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                              timeout=600)
    say(f"[cli] {' '.join(cmd[1:4])} ... --validate: exit "
        f"{proc.returncode} in {time.perf_counter() - t0:.1f} s")
    for line in proc.stdout.splitlines():
        if line.startswith(("[checkResults", "[bsmr_sddmm ", "[device")):
            say(f"[cli]   {line}")
    if proc.returncode != 0 or "[checkResults : pass]" not in proc.stdout:
        return [f"cli exit {proc.returncode}: {proc.stderr[-2000:]}"]
    return []


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
