"""Host allocator tuning for the packing hot path.

A copy of ``bsmr_sddmm_tpu.utils.hostmem``. First-touch page faults on
fresh mmap-backed numpy allocations run at ~25-200 MB/s on a small host, so
the T-sized ``(T, ph, bw)`` scatter-map buffers ``pack_tiles`` builds at
low delta make packing allocation-bound (the JAX package measured a
2.2M-nnz replica packing in 22 s on a one-core host, over half of it
``np.full`` page-faulting). Raising glibc's M_MMAP_THRESHOLD /
M_TRIM_THRESHOLD keeps those buffers in the (already-faulted) heap so
repeated packs reuse warm pages: the same pack dropped to 4-7 s.

Harness entry points (``bench.suite``, ``bench.replica_suite``) call
:func:`tune_malloc` explicitly; the library never mutates the global
allocator on import.
"""
import ctypes

M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3


def tune_malloc(threshold_bytes: int = 1 << 30) -> bool:
    """Serve allocations below ``threshold_bytes`` from the glibc heap
    (warm pages) instead of fresh mmaps. Returns True if applied;
    no-op (False) on non-glibc platforms."""
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
        libc.mallopt.restype = ctypes.c_int
        ok = libc.mallopt(M_MMAP_THRESHOLD, threshold_bytes)
        ok = libc.mallopt(M_TRIM_THRESHOLD, threshold_bytes) and ok
        return bool(ok)
    except OSError:
        return False


def rss_gb() -> float:
    """Current process resident set size in GiB (the suites print it
    beside their phase totals)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / (1 << 20)
    return 0.0
