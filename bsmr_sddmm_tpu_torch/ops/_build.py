"""Build and load the hand-written CUDA kernels (csrc/*.cu).

``nvcc`` compiles the sources in this package's ``csrc/`` into one shared
library with a plain C interface, for ``sm_90a`` (Hopper), at first use.
Each source compiles in its own ``nvcc`` process, all started together,
and one more links the objects:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas=-v -c -o <src>.o csrc/<src>.cu   (each)
    nvcc -shared -o libbsmr_torch_kernels.so *.o

The library lands in ``build/torch_kernels/<hash of sources + flags>/`` at
the root of the checkout (``BSMR_TORCH_KERNEL_DIR`` overrides the parent
directory) and is reused while the sources are unchanged. Nothing here
falls back: a missing ``nvcc`` or a failed compile raises. The build or
load is recorded as the span ``kernels.load``; ``build_info`` says which.
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

from bsmr_sddmm_tpu_torch.utils.profiling import span

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SOURCES = ("bsr_dense.cu", "subpack.cu", "gathered_tile.cu", "csr_emit.cu",
           "residual.cu")
HEADERS = ("tile_mma.cuh", "tile_wgmma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
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


def _run_all(cmds: list) -> str:
    """Run the commands concurrently, wait for every one of them, and
    return their joined output; raises if any failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for proc, cmd, out in zip(procs, cmds, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def compile_sources(out: str, csrc: str = _CSRC, sources=SOURCES) -> str:
    """Compile ``sources`` of the directory ``csrc`` into the shared library
    ``out`` (one nvcc each, all started together, and one to link) and
    return the compiler's report."""
    build = os.path.dirname(out)
    os.makedirs(build, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    nvcc = find_nvcc()
    objs = [os.path.join(build, f"{src}.{tag}.o") for src in sources]
    report = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                        os.path.join(csrc, src)]
                       for src, obj in zip(sources, objs)])
    tmp = f"{out}.{tag}"
    report += _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, out)
    return report


def _compile(out: str) -> None:
    t0 = time.perf_counter()
    report = compile_sources(out)
    build_info.update(compiled=True, seconds=time.perf_counter() - t0,
                      report=report)


def bind_subpack(lib: ctypes.CDLL) -> None:
    """Declare ``bsmr_subpack``'s C signature on a loaded library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bsmr_subpack.restype = i
    lib.bsmr_subpack.argtypes = [p] * 6 + [i] * 10 + [p]


def load_library() -> ctypes.CDLL:
    """The kernel library, compiled on first use; raises on any failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with span("kernels.load"):
            _lib = _load()
        return _lib


def _load() -> ctypes.CDLL:
    """Build the kernel library where it is not there, load and bind it."""
    path = library_path()
    if not os.path.exists(path):
        _compile(path)
    else:
        build_info.update(compiled=False, seconds=0.0, report="")
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bsmr_bsr_dense.restype = i
    lib.bsmr_bsr_dense.argtypes = [p] * 5 + [i] * 8 + [p]
    lib.bsmr_bsr_dense_route.restype = i
    lib.bsmr_bsr_dense_route.argtypes = [i] * 4 + [
        ctypes.POINTER(ctypes.c_longlong)]
    bind_subpack(lib)
    lib.bsmr_gathered_tile.restype = i
    lib.bsmr_gathered_tile.argtypes = [p] * 5 + [i] * 7 + [p]
    lib.bsmr_csr_emit.restype = i
    lib.bsmr_csr_emit.argtypes = [p] * 4 + [i] * 4 + [p] * 2 + [i] * 2 + [p]
    lib.bsmr_residual.restype = i
    lib.bsmr_residual.argtypes = [p] * 5 + [i] * 3 + [p]
    build_info["path"] = path
    return lib
