"""The thread budget of ``tests/_torch_threads.py``, read back inside the
worker that runs this test."""

import ctypes
import os

import torch

import _torch_threads

from bsmr_sddmm_tpu_torch import native


def test_every_pool_holds_the_worker_budget():
    """torch's pool and the OpenMP runtime that the port's clustering
    library runs on (looked up through the library itself) hold the budget,
    as does every libgomp mapped into the process and the environment that
    the processes a test starts inherit."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = _torch_threads.budget()
    assert n == max(1, os.cpu_count() // workers)
    assert os.environ["OMP_NUM_THREADS"] == str(n)
    assert torch.get_num_threads() == n
    assert native.available()
    with open("/proc/self/maps") as f:
        mapped = {ln.split()[-1] for ln in f}
    gomps = [p for p in mapped if os.path.basename(p).startswith("libgomp")]
    assert gomps
    for lib in [native._lib] + [ctypes.CDLL(p) for p in gomps]:
        getter = lib.omp_get_max_threads
        getter.argtypes, getter.restype = [], ctypes.c_int
        assert getter() == n
