"""One process of the multi-process sharded SDDMM run.

    python -m bsmr_sddmm_tpu_torch.parallel.worker <pid> <nproc> <port>
        [--device D] [--matrix NAME] [--backend gloo|nccl]

Start ``nproc`` of them, with ``pid`` 0 .. nproc-1 and one free TCP port.
Each process calls ``distributed.initialize`` against ``localhost:<port>``,
owns 2 shards of a (2 * nproc)-shard mesh, both on ``--device`` (default
``cuda:<pid % cards>``; with no card visible the worker raises unless
``--device cpu`` is asked for), and runs

* ``make_sharded_sddmm(b_sharded=True, emit="csr")``, whose all-gather of
  B crosses the process boundary, and
* ``make_ring_sddmm(emit="csr")``, whose hops cross it,

each checked against the fp64 oracle on a counted call (its collective
counts and kernel launches), then timed over ``ITERATIONS`` calls after a
warm-up one (``utils.timing``: CUDA events on the card, the host clock on
the CPU). Every process packs every shard's
plan itself, so the line carries a hash of the shard plans and the ring
plan, which must agree between processes. The mask is the JAX worker's
(``banded(512, 16000, 64, seed=11)`` at K=32), or the SUITE matrix
``--matrix`` at K=128 with its R4_BEST arm. On ``gloo`` a CUDA tensor
crosses the process boundary through host memory (``host_staged``); two
processes on one card need ``gloo``, ``nccl`` needs a card per process.
``--backend`` defaults to ``nccl`` on a card when every process can have
its own (``nproc`` cards visible), else ``gloo``.
Prints one JSON line and exits 0 when both checks pass.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys

import numpy as np
import torch


def plan_hash(plans, ring_plan) -> str:
    """sha256 (16 hex digits) over every array and value of the shard
    plans and the ring plan."""
    h = hashlib.sha256()
    for obj in list(plans) + [ring_plan]:
        for f in dataclasses.fields(obj):
            if f.name == "pack_time_ms":
                continue
            v = getattr(obj, f.name)
            h.update(f.name.encode())
            h.update(np.ascontiguousarray(v).tobytes()
                     if isinstance(v, np.ndarray) else repr(v).encode())
    return h.hexdigest()[:16]


def _problem(matrix):
    from bsmr_sddmm_tpu_torch.config import SddmmConfig
    from bsmr_sddmm_tpu_torch.datasets import SUITE, banded
    if matrix is None:
        cfg = SddmmConfig(k=32, panel_height=16, dense_chunk=16,
                          residual_chunk=2048)
        return banded(512, 16000, 64, seed=11), cfg
    from bsmr_sddmm_tpu_torch.bench.suite import R4_BEST
    alpha, delta, subpack, _ = R4_BEST[(matrix, 128)]
    cfg = SddmmConfig(k=128, alpha=alpha, delta=delta,
                      subpack_min_nnz=subpack)
    return dict(SUITE)[matrix](), cfg


KERNELS = ("bsr_dense", "subpack", "dense_tile", "fused_gathered")


#: timed calls a path, after its counted call and one warm-up
ITERATIONS = 5


def _counted(fn, *args, device):
    """One call with the collective counters set to 0 just before it: its
    result, and its collective counts and kernel launches."""
    from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
    from bsmr_sddmm_tpu_torch.parallel import collectives
    collectives.zero_counts()
    launches = {name: getattr(dk, name).launches for name in KERNELS}
    out = fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, dict(collectives.read_counts(), **{
        name: getattr(dk, name).launches - n for name, n in launches.items()})


def _ms(fn, *args, device) -> float:
    """Mean milliseconds a call over ``ITERATIONS`` calls: CUDA events on
    the card, the host clock on the CPU."""
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda, time_host
    if device.type != "cuda":
        return time_host(fn, *args, iterations=ITERATIONS)[0]
    with torch.cuda.device(device):
        return time_cuda(fn, *args, iterations=ITERATIONS)[0]


def _device(arg, pid: int) -> torch.device:
    """``--device``, or this process's card (``cuda:<pid % cards>``)."""
    if arg is not None:
        return torch.device(arg)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible: pass --device cpu to run "
                           "the worker on the CPU")
    return torch.device(f"cuda:{pid % torch.cuda.device_count()}")


def _backend(arg, device: torch.device, nproc: int) -> str:
    """``--backend``, or nccl where every process has a card of its own,
    else gloo (CPU tensors, or processes sharing a card)."""
    if arg is not None:
        return arg
    if device.type == "cuda" and torch.cuda.device_count() >= nproc:
        return "nccl"
    return "gloo"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pid", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--device", default=None)
    ap.add_argument("--matrix", default=None)
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from bsmr_sddmm_tpu_torch.ops.sddmm import sddmm_ref
    from bsmr_sddmm_tpu_torch.parallel import distributed
    from bsmr_sddmm_tpu_torch.parallel.ring import (make_ring_sddmm,
                                                    ring_operands)
    from bsmr_sddmm_tpu_torch.parallel.sharding import (make_mesh,
                                                        make_sharded_sddmm,
                                                        shard_operands)
    from bsmr_sddmm_tpu_torch.formats import make_dense
    from bsmr_sddmm_tpu_torch.reorder import bsmr
    from bsmr_sddmm_tpu_torch.utils.checkdata import check_data

    device = _device(args.device, args.pid)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(f"localhost:{args.port}", args.nproc, args.pid,
                           backend=_backend(args.backend, device, args.nproc))
    try:
        mesh = make_mesh(devices=[device, device])
        if mesh.size != 2 * args.nproc:
            raise RuntimeError(f"mesh of {mesh.size} shards, expected "
                               f"{2 * args.nproc}")
        csr, cfg = _problem(args.matrix)
        reord = bsmr(csr, cfg)
        A = make_dense(csr.rows, cfg.k, seed=1)
        Bt = make_dense(csr.cols, cfg.k, seed=2)
        expected = sddmm_ref(A, Bt.T, csr)

        # B column panels sharded over the global mesh: the all-gather
        # is a real cross-process collective
        fn, dplan, plans = make_sharded_sddmm(csr, reord, cfg, mesh,
                                              b_sharded=True, emit="csr")
        A_dev, Bt_dev = shard_operands(A, Bt, mesh, b_sharded=True)
        out, sharded_counts = _counted(fn, A_dev, Bt_dev, dplan,
                                       device=device)
        res = check_data(expected, out.cpu().numpy())
        sharded_ms = _ms(fn, A_dev, Bt_dev, dplan, device=device)
        # ring layout: B stays sharded; each hop crosses the process
        # boundary once
        fn_ring, rplan = make_ring_sddmm(csr, reord, cfg, mesh, emit="csr")
        A_r, Bt_r = ring_operands(A, Bt, rplan, mesh)
        out_ring, ring_counts = _counted(fn_ring, A_r, Bt_r, device=device)
        res_ring = check_data(expected, out_ring.cpu().numpy())
        ring_ms = _ms(fn_ring, A_r, Bt_r, device=device)
        backend = dist.get_backend()
        print(json.dumps({
            "process": args.pid, "num_processes": dist.get_world_size(),
            "global_devices": mesh.size, "shards": len(plans),
            "nnz": int(csr.nnz), "device": str(device),
            "backend": backend,
            "host_staged": device.type == "cuda" and backend == "gloo",
            "plan_hash": plan_hash(plans, rplan),
            "b_sharded_all_gather": True,
            "check": "pass" if res.passed else "fail",
            "error_rate": float(res.error_rate),
            "ring_check": "pass" if res_ring.passed else "fail",
            "ring_error_rate": float(res_ring.error_rate),
            "sharded_ms": sharded_ms, "ring_ms": ring_ms,
            "timed_calls": ITERATIONS,
            "sharded_counts": sharded_counts, "ring_counts": ring_counts,
        }), flush=True)
        return 0 if res.passed and res_ring.passed else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
