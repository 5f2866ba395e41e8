"""Build and load the hand-written CUDA kernels (csrc/*.cu).

``nvcc`` compiles the sources in this package's ``csrc/`` into one shared
library with a plain C interface, for ``sm_90a`` (Hopper), at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o libbsmr_torch_kernels.so csrc/*.cu

The library lands in ``build/torch_kernels/<hash of sources + flags>/`` at
the root of the checkout (``BSMR_TORCH_KERNEL_DIR`` overrides the parent
directory) and is reused while the sources are unchanged. Nothing here
falls back: a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SOURCES = ("bsr_dense.cu", "subpack.cu")
HEADERS = ("tile_matmul.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_LIB_NAME = "libbsmr_torch_kernels.so"
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: How the library was obtained: path, whether this process compiled it,
#: the compile's wall seconds and the compiler's report (ptxas registers).
build_info: dict = {}


def kernel_dir() -> str:
    """Parent directory of the per-hash build directories."""
    root = os.path.dirname(os.path.dirname(_CSRC))
    return os.environ.get("BSMR_TORCH_KERNEL_DIR") or os.path.join(
        root, "build", "torch_kernels")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(kernel_dir(), _digest(), _LIB_NAME)


def find_nvcc() -> str:
    """``nvcc`` from CUDA_HOME, PATH or /usr/local/cuda; raises if absent."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", _DEFAULT_NVCC]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of bsmr_sddmm_tpu_torch cannot be built")


def _compile(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(_CSRC, s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(compiled=True, seconds=seconds,
                      report=proc.stdout + proc.stderr)


def load_library() -> ctypes.CDLL:
    """The kernel library, compiled on first use; raises on any failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _compile(path)
        else:
            build_info.update(compiled=False, seconds=0.0, report="")
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bsmr_bsr_dense.restype = i
        lib.bsmr_bsr_dense.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.bsmr_subpack.restype = i
        lib.bsmr_subpack.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        build_info["path"] = path
        _lib = lib
        return _lib
