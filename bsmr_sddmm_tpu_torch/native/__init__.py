"""Native (C++/OpenMP) preprocessing runtime.

The loader of ``cluster.cpp``, a byte-identical copy of
``bsmr_sddmm_tpu/native/cluster.cpp`` (tests/test_torch_host.py checks
that). It runs the host-side hot loop of preprocessing, greedy row
clustering. The shared library is compiled on first use with g++ (plain C
ABI + ctypes) and cached in a temporary directory keyed by a source hash,
so an editable install needs no build step and a missing toolchain
degrades to the NumPy implementation in reorder.py. That fallback is
preprocessing on the host, not the device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cluster.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build_dir() -> str:
    d = os.environ.get("BSMR_NATIVE_CACHE") or os.path.join(
        tempfile.gettempdir(), f"bsmr_native_{os.getuid()}")
    os.makedirs(d, exist_ok=True)
    return d


def _compile() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_build_dir(), f"libbsmr_cluster_{tag}.so")
    if os.path.exists(out):
        return out
    tmp = out + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           "-std=c++17", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = ctypes.CDLL(_compile())
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"bsmr_sddmm_tpu_torch: native clustering unavailable "
                  f"({type(e).__name__}); using the NumPy fallback",
                  file=sys.stderr)
            _load_failed = True
            return None
        i64, i64p = ctypes.c_int64, np.ctypeslib.ndpointer(np.int64)
        i32p = np.ctypeslib.ndpointer(np.int32)
        f64p = np.ctypeslib.ndpointer(np.float64)
        lib.bsmr_cluster_fast.restype = ctypes.c_int64
        lib.bsmr_cluster_fast.argtypes = [
            i64, i64p, i32p, f64p, f64p, i64, ctypes.c_double, i64p]
        lib.bsmr_cluster_exact.restype = ctypes.c_int64
        lib.bsmr_cluster_exact.argtypes = [
            i64, i64p, i32p, f64p, f64p, f64p, i64, ctypes.c_double, i64p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def cluster(indptr: np.ndarray, indices: np.ndarray,
            data_raw: np.ndarray, data_hat: np.ndarray,
            l1_hat: np.ndarray, nblocks: int, alpha: float,
            exact: bool = False) -> Optional[np.ndarray]:
    """Greedy clustering over CSR row encodings (rows in
    ascending-dispersion order); ``data_raw`` are the unnormalized values
    (accumulated by the exact strategy), ``data_hat`` the L2-normalized
    ones (compared against). Returns 0-based cluster ids per row, or None
    if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    R = indptr.shape[0] - 1
    out = np.empty(R, dtype=np.int64)
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data_raw = np.ascontiguousarray(data_raw, np.float64)
    data_hat = np.ascontiguousarray(data_hat, np.float64)
    l1_hat = np.ascontiguousarray(l1_hat, np.float64)
    if exact:
        ncl = lib.bsmr_cluster_exact(R, indptr, indices, data_raw,
                                     data_hat, l1_hat, int(nblocks),
                                     float(alpha), out)
    else:
        ncl = lib.bsmr_cluster_fast(R, indptr, indices, data_hat, l1_hat,
                                    int(nblocks), float(alpha), out)
    assert ncl >= 0
    return out
