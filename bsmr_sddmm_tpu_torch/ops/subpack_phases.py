"""Where the packed tier's time goes on the card: ``subpack`` built from
scratch copies of ``csrc/`` with one phase left out, or with the hot columns
materialised first.

    python -m bsmr_sddmm_tpu_torch.ops.subpack_phases

The kernel sources hold one design and no switches. This script copies
``csrc/`` into a temporary directory once per variant, edits the copy (an
edit whose text is not found exactly once fails the run, so the script
cannot drift from the sources unnoticed), compiles each copy's
``subpack.cu`` (all ``nvcc`` started together) and times every variant's
``bsmr_subpack`` at three TF32 passes as a replayed CUDA graph, twice, in
turns, on the packed tiers of banded_mesh_32k: the bsr plan (alpha 0.3,
delta 0.002) at K = 128 and 32 and the ``col_mode="reorder"`` plan (alpha
0.3, delta 0.05) at K = 128, subpack 12, fp32 out.

Variants:

- ``whole``: the sources as they are (the hot columns read through
  ``sp_colperm`` inside the kernel);
- ``bt2``: the kernel reads sub-blocks of a materialised ``Bt2 =
  Bt[sp_colperm]`` instead, as the JAX package's kernel does;
- ``no_copies``, ``no_mmas``, ``no_stores``: one phase of the streaming tile
  left out; ``no_split``: the MMA loop fed the raw fp32 bits three times,
  without the hi / lo conversions (``no_a_split``: of the A operand
  alone); ``mmas_alone``: neither copies nor conversions. Their results are wrong by design; only ``whole`` and
  ``bt2`` are held against ``subpack_plain``.

Then the packed tier as a whole, the A-row gather included, as the body
runs it (``make_sddmm_body(..., only_tier="packed")``) against the same
tier with ``Bt2`` materialised by ``index_select`` before the ``bt2``
kernel; and the lengths of the runs of tiles that share a panel. Needs a
CUDA device and ``nvcc``; prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import bsmr_sddmm_tpu_torch as bt
from bsmr_sddmm_tpu_torch import datasets
from bsmr_sddmm_tpu_torch.ops import _build
from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.ops.sddmm import device_plan, make_sddmm_body
from bsmr_sddmm_tpu_torch.utils.timing import time_cuda_graph

#: variant -> edits (file, text found exactly once, its replacement)
VARIANTS = {
    "whole": (),
    "bt2": (("subpack.cu", "const int n = sp_colperm[h];",
             "const int n = static_cast<int>(h);"),),
    "no_copies": (("tile_mma.cuh", "    if (chunk < chunks) {\n      float* As",
                   "    if (chunk < 0) {\n      float* As"),),
    "no_mmas": (("tile_mma.cuh",
                 "    warp_mma<TL::MI, TL::NJ, PASSES>(acc, As + row0 * "
                 "kChunkStride,\n"
                 "                                     Bs + col0 * "
                 "kChunkStride,\n"
                 "                                     kChunkStride, "
                 "kChunkK / 8);\n",
                 "    if (K < 0) acc[0][0][0] = As[row0] + Bs[col0];\n"),),
    "no_split": (("tile_mma.cuh",
                  "          tf32_split(__uint_as_float(raw[e]), ahi[i][e], "
                  "alo[i][e]);",
                  "          ahi[i][e] = alo[i][e] = raw[e];"),
                 ("tile_mma.cuh",
                  "            tf32_split(__uint_as_float(h[e]), h[e], l[e]);",
                  "            l[e] = h[e];")),
    "no_stores": (("tile_mma.cuh",
                   "  store_tile<PH, BW>(acc, out, row0, col0);\n}",
                   "  if (K < 0) store_tile<PH, BW>(acc, out, row0, col0);\n}"),),
}
VARIANTS["mmas_alone"] = VARIANTS["no_copies"] + VARIANTS["no_split"]
VARIANTS["no_a_split"] = VARIANTS["no_split"][:1]
CHECKED = ("whole", "bt2")
PLANS = (("bsr", dict(alpha=0.3, delta=0.002), (128, 32)),
         ("reorder", dict(alpha=0.3, delta=0.05, col_mode="reorder",
                          gathered_backend="fused"), (128,)))


def copy_variant(name: str, root: str) -> str:
    """Copy csrc/ to ``root/name/csrc`` with the variant's edits applied;
    raises unless every edit's text is found exactly once."""
    csrc = os.path.join(root, name, "csrc")
    shutil.copytree(_build._CSRC, csrc)
    for fname, old, new in VARIANTS[name]:
        path = os.path.join(csrc, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: edit of {fname} matches "
                               f"{text.count(old)} times, not once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return csrc


def build_variant(name: str, root: str) -> ctypes.CDLL:
    """Compile subpack.cu of the variant's copy and load it."""
    out = os.path.join(root, name, "libsubpack.so")
    _build.compile_sources(out, csrc=copy_variant(name, root),
                           sources=("subpack.cu",))
    lib = ctypes.CDLL(out)
    _build.bind_subpack(lib)
    return lib


def launcher(lib, A_panels, B, colperm, sp_panel, sp_sub, sw, H):
    """fn() -> out: one launch of the variant's kernel on the current
    stream (read at call time: a graph capture changes it)."""
    Tp, S = sp_sub.shape
    ph, K = A_panels.shape[1], A_panels.shape[2]

    def fn():
        out = torch.empty((Tp, ph, S * sw), dtype=torch.float32,
                          device=A_panels.device)
        err = lib.bsmr_subpack(
            A_panels.data_ptr(), B.data_ptr(), colperm.data_ptr(),
            sp_panel.data_ptr(), sp_sub.data_ptr(), out.data_ptr(), Tp, S,
            sw, ph, S * sw, K, H, B.shape[0], 0, 3,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"bsmr_subpack: cudaError {err}")
        return out
    return fn


def in_turns(fns: dict) -> dict:
    """name -> (first ms, second ms): every fn timed once, then again."""
    first = {name: time_cuda_graph(fn)[0] for name, fn in fns.items()}
    return {name: (first[name], time_cuda_graph(fn)[0])
            for name, fn in fns.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("subpack_phases: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[phases] {smi}", flush=True)
    csr = dict(datasets.SUITE)["banded_mesh_32k"]()
    failed = []
    with tempfile.TemporaryDirectory() as root:
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            libs = dict(zip(VARIANTS, pool.map(
                lambda name: build_variant(name, root), VARIANTS)))
        for mode, arm, ks in PLANS:
            for k in ks:
                cfg = bt.SddmmConfig(k=k, subpack_min_nnz=12, **arm)
                plan = bt.pack_tiles(csr, bt.BsmrSddmm(csr, cfg).reorder(),
                                     cfg)
                dp = device_plan(plan, dev, emit="rphm")
                sw = plan.subblock_width
                A = torch.from_numpy(bt.make_dense(csr.rows, k, seed=1337)
                                     ).to(dev)
                Bt = torch.from_numpy(bt.make_dense(k, csr.cols, seed=1338
                                                    ).T.copy()).to(dev)
                A_panels = A.index_select(0, dp.row_perm_padded).reshape(
                    plan.num_panels, plan.panel_height, k)
                Bt2 = Bt.index_select(0, dp.sp_colperm)
                H = dp.sp_colperm.shape[0]
                real = plan.sp_panel[:plan.num_packed]
                runs = np.diff(np.flatnonzero(np.diff(real, prepend=-1,
                                                      append=-1)))
                print(f"[phases] banded_mesh_32k {mode} K={k}: Tp="
                      f"{plan.sp_panel.shape[0]} (real {plan.num_packed}), "
                      f"H={H}, sw={sw}; runs of tiles on one panel: "
                      f"{runs.size} runs, mean {runs.mean():.2f}, max "
                      f"{runs.max()}, of length 1: {(runs == 1).sum()}",
                      flush=True)
                fns = {name: launcher(
                    lib, A_panels, Bt2 if name == "bt2" else Bt,
                    dp.sp_colperm, dp.sp_panel, dp.sp_sub, sw, H)
                    for name, lib in libs.items()}
                want = dk.subpack_plain(A_panels, Bt, dp.sp_colperm,
                                        dp.sp_panel, dp.sp_sub,
                                        subblock_width=sw)
                for name in CHECKED:
                    got = fns[name]()
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    ok = torch.allclose(got, want, rtol=1e-5, atol=1e-4)
                    print(f"[phases]   {name}: max_abs {err:.3e} vs "
                          f"subpack_plain {'ok' if ok else 'MISMATCH'}")
                    if not ok:
                        failed.append(f"{mode} K={k} {name}")
                for name, (t1, t2) in in_turns(fns).items():
                    print(f"[phases]   kernel {name}: {(t1 + t2) / 2:.4f} ms"
                          f" ({t1:.4f}, {t2:.4f})", flush=True)
                # the tier as the body runs it, and with Bt2 materialised
                body = make_sddmm_body(plan, cfg, emit="rphm",
                                       only_tier="packed")

                def tier_bt2():
                    panels = A.index_select(0, dp.row_perm_padded).reshape(
                        plan.num_panels, plan.panel_height, k)
                    b2 = Bt.index_select(0, dp.sp_colperm)
                    return launcher(libs["bt2"], panels, b2, dp.sp_colperm,
                                    dp.sp_panel, dp.sp_sub, sw, H)()

                tiers = in_turns({"in the kernel": lambda: body(A, Bt, dp),
                                  "Bt2 materialised": tier_bt2})
                for name, (t1, t2) in tiers.items():
                    print(f"[phases]   packed tier, hot columns {name}: "
                          f"{(t1 + t2) / 2:.4f} ms ({t1:.4f}, {t2:.4f})",
                          flush=True)
    if failed:
        print(f"subpack_phases: FAIL: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
