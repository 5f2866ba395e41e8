"""Process bootstrap and the weak-scaling measurement.

The counterpart of ``bsmr_sddmm_tpu.parallel.distributed``. Usage with
several processes (one per card, or several sharing a card on ``gloo``):

    from bsmr_sddmm_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize("localhost:29500", num_processes=2,
                           process_id=rank)    # or torchrun's environment
    mesh = make_mesh(devices=[f"cuda:{rank}"])  # this process's shards

Sharding and collectives live in ``parallel.sharding`` and
``parallel.collectives``; this module owns process bootstrap and the
weak-scaling measurement (nnz/s at 1, 2, 4 ... shards with the same work
per shard).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Initialise ``torch.distributed`` for a run of several processes.

    The arguments default to torchrun's environment (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). A no-op in a single
    process (no address and at most one process) and when the process
    group already exists. ``coordinator_address`` is ``host:port`` or a
    ``tcp://`` URL; ``backend`` is ``nccl`` where CUDA is available and
    ``gloo`` otherwise, unless named (two processes sharing one card need
    ``gloo``: NCCL refuses two ranks on one GPU)."""
    import torch.distributed as dist
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if num_processes in (None, 1) and not coordinator_address:
        return
    if dist.is_initialized():
        return
    if not coordinator_address or num_processes is None \
            or process_id is None:
        raise ValueError("initialize needs the coordinator address, the "
                         "number of processes and this process's id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def _devices_of(args) -> set:
    """The devices of the tensors in ``args`` (nested lists, tuples and
    DevicePlans)."""
    if isinstance(args, torch.Tensor):
        return {args.device}
    if isinstance(args, (list, tuple)):
        return set().union(*(_devices_of(a) for a in args)) if args else set()
    return set()


def join_devices(fn, devices):
    """``fn`` followed by the first CUDA device's current stream waiting
    for every other device's, so that CUDA events on the first device time
    the work of all of them."""
    first, rest = devices[0], devices[1:]

    def call(*args):
        out = fn(*args)
        for dev in rest:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            torch.cuda.current_stream(first).wait_event(ev)
        return out
    return call


def weak_scaling(plan_fn, device_counts: Sequence[int],
                 iterations: int = 10) -> dict:
    """Measure nnz/s at each device count (same per-device work: the
    caller's plan_fn(n) returns (fn, args, nnz) for an n-shard mesh).
    Calls on CUDA tensors are timed with CUDA events (``time_cuda``), on
    CPU tensors with the host clock (``time_host``, never a device
    time).

    Returns {n: {"ms": ..., "nnz_per_s": ..., "efficiency": ...}} with
    efficiency relative to perfect scaling from the smallest count."""
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda, time_host
    results = {}
    base_rate = None
    for n in device_counts:
        fn, args, nnz = plan_fn(n)
        cuda = sorted((d for d in _devices_of(args) if d.type == "cuda"),
                      key=str)
        if cuda:
            with torch.cuda.device(cuda[0]):
                ms, _ = time_cuda(join_devices(fn, cuda), *args,
                                  iterations=iterations)
        else:
            ms, _ = time_host(fn, *args, iterations=iterations)
        rate = nnz / (ms * 1e-3)
        if base_rate is None:
            base_rate = rate / n
        results[n] = {"ms": ms, "nnz_per_s": rate,
                      "efficiency": rate / (base_rate * n)}
    return results


def sddmm_weak_scaling(device_counts: Sequence[int],
                       rows_per_device: int = 8192,
                       nnz_per_device: int = 500_000,
                       cols: int = 8192, k: int = 128,
                       bandwidth: int = 256,
                       config=None,
                       iterations: int = 10,
                       seed: int = 7,
                       devices: Optional[Sequence] = None) -> dict:
    """Weak scaling of the REAL sharded hybrid SDDMM (make_sharded_sddmm,
    emit="rphm"): per shard, a constant slice of a banded mask
    (rows_per_device x cols, nnz_per_device nonzeros). Rows and nnz grow
    with the mesh; B is replicated (column space fixed). The mesh at
    count n is ``make_mesh(n, devices)``: the first n of ``devices``
    (the visible cards by default; a repeated card runs its shards one
    after another, which measures the structure and not scaling).
    Cropping the columns narrows the band as n grows, so a shard's dense
    tiles grow while its packed and residual slots shrink: the work per
    shard is constant only to within a bucket step.

    Returns the weak_scaling() dict; each count's entry also lists its
    shard plans' shapes under ``"shard_shapes"`` (tiles, packed tiles,
    gathered tiles, residual slots, panels), one tuple per shard."""
    from bsmr_sddmm_tpu_torch.config import SddmmConfig
    from bsmr_sddmm_tpu_torch.datasets import banded
    from bsmr_sddmm_tpu_torch.formats import make_dense
    from bsmr_sddmm_tpu_torch.parallel.sharding import (make_mesh,
                                                        make_sharded_sddmm,
                                                        shard_operands)
    from bsmr_sddmm_tpu_torch.reorder import bsmr as bsmr_reorder

    cfg = config or SddmmConfig(k=k, panel_height=32)
    shapes = {}

    def plan_fn(n):
        csr = banded(n * rows_per_device, n * nnz_per_device,
                     bandwidth, seed=seed)
        # banded() is square; crop columns to the fixed per-run width so
        # B stays constant-size as the mesh grows
        csr = _crop_cols(csr, cols)
        mesh = make_mesh(n, devices)
        reord = bsmr_reorder(csr, cfg)
        fn, dplan, plans = make_sharded_sddmm(csr, reord, cfg, mesh, k=k,
                                              emit="rphm")
        shapes[n] = [(p.tile_panel.shape[0], p.sp_panel.shape[0],
                      p.g_panel.shape[0], p.res_arow.shape[0],
                      p.num_panels) for p in plans]
        A = make_dense(csr.rows, k, seed=1)
        Bt = make_dense(csr.cols, k, seed=2)
        A_dev, Bt_dev = shard_operands(A, Bt, mesh)
        return (fn, (A_dev, Bt_dev, dplan), csr.nnz)

    results = weak_scaling(plan_fn, device_counts, iterations=iterations)
    for n, rec in results.items():
        rec["shard_shapes"] = shapes[n]
    return results


def _crop_cols(csr, cols: int):
    """Project a CSR mask onto its first ``cols`` columns, rescaling
    column ids (keeps per-row counts roughly constant)."""
    import numpy as np
    from bsmr_sddmm_tpu_torch.formats import COO
    if csr.cols <= cols:
        return csr
    scale = cols / csr.cols
    new_c = np.minimum((csr.col_indices * scale).astype(np.int64),
                       cols - 1)
    key = csr.coo_rows().astype(np.int64) * cols + new_c
    uniq = np.unique(key)
    return COO(csr.rows, cols, (uniq // cols).astype(np.int32),
               (uniq % cols).astype(np.int32),
               np.ones(uniq.size, np.float32)).to_csr()
