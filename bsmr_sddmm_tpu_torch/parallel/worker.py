"""One process of the multi-process sharded SDDMM run, or of the
multi-process train step.

    python -m bsmr_sddmm_tpu_torch.parallel.worker <pid> <nproc> <port>
        [--device D] [--matrix NAME] [--backend gloo|nccl]
        [--train]

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

With ``--train`` the process instead takes ``TRAIN_STEPS`` Adam steps (at
``TRAIN_LR``) of the graph transformer on the mask
(``train_problem``: features 16, ``head_dim`` the mask's K, 4 heads, 2
layers, 8 classes, weights of seed 0), its attention over the process's 2
shards (``make_forward(..., mesh=)``). Each layer's head outputs are
summed across the processes in the forward and q, k, v's gradients in the
backward (``collectives.from_shards`` / ``to_shards``), so every process
ends with the same parameters. The JSON line carries the losses, a hash
of the final parameters (``param_hash``), the steps' collective counts,
kernel launches and cross-process bytes, and ms a step over the last two
steps (``utils.timing``); exit 0 when every loss is finite.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import torch


def plan_hash(plans) -> str:
    """sha256 (16 hex digits) over every array and value of ``plans``
    (shard plans, and the ring plan)."""
    h = hashlib.sha256()
    for obj in plans:
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


#: timed calls a path, after its counted call and one warm-up
ITERATIONS = 5
#: Adam steps of the --train run (the last two are timed)
TRAIN_STEPS = 3
#: their learning rate: at the JAX package's default, 1e-3, the loss of the
#: full-width graph transformer on community_20k rises (the step's size)
TRAIN_LR = 1e-5


def train_problem(matrix):
    """The --train run's mask, config, graph transformer and its inputs
    (features normal, labels uniform over the classes, NumPy from seed
    2): the model is 16 features, ``head_dim`` the config's K, 4 heads, 2
    layers, 8 classes."""
    from bsmr_sddmm_tpu_torch.models.graph_transformer import GraphTransformer
    csr, cfg = _problem(matrix)
    model = GraphTransformer(num_nodes=csr.rows, feature_dim=16,
                             head_dim=cfg.k)
    rng = np.random.default_rng(2)
    X = rng.standard_normal((model.num_nodes, model.feature_dim)).astype(
        np.float32)
    labels = rng.integers(0, model.num_classes, model.num_nodes)
    return csr, cfg, model, X, labels


def param_hash(net) -> str:
    """sha256 (16 hex digits) over every parameter's name and bytes."""
    h = hashlib.sha256()
    for name, p in net.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _train(matrix, mesh, device) -> dict:
    """``TRAIN_STEPS`` Adam steps of ``train_problem``'s graph transformer
    over ``mesh``: the JSON line's train fields."""
    from bsmr_sddmm_tpu_torch.models import graph_transformer as gt
    csr, cfg, model, X, labels = train_problem(matrix)
    net, dplan, plans = gt.make_forward(model, csr, cfg, device=device,
                                        mesh=mesh)
    opt_init, step = gt.make_train_step(model, net, TRAIN_LR)
    opt = opt_init()
    X = torch.from_numpy(X).to(device)
    labels = torch.from_numpy(labels).to(device)
    losses = []

    def one_step():
        losses.append(step(opt, X, labels, dplan))

    # the first step is the timer's warm-up
    ms, counts = _counted(lambda: _ms(one_step, device=device,
                                      iterations=TRAIN_STEPS - 1),
                          device=device)
    losses = [float(x) for x in losses]
    return {
        "shards": len(plans), "plan_hash": plan_hash(plans),
        "losses": losses, "param_hash": param_hash(net),
        "step_ms": ms, "timed_steps": TRAIN_STEPS - 1, "counts": counts,
        "check": "pass" if all(np.isfinite(losses)) else "fail",
    }


def _counted(fn, *args, device):
    """One call with the collective counters set to 0 just before it: its
    result, and its collective counts and kernel launches."""
    from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
    from bsmr_sddmm_tpu_torch.parallel import collectives
    collectives.zero_counts()
    launches = {kern: kern.launches for kern in dk.WRAPPERS}
    out = fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, dict(collectives.read_counts(), **{
        kern.__name__: kern.launches - n for kern, n in launches.items()})


def _ms(fn, *args, device, iterations=ITERATIONS) -> float:
    """Mean milliseconds a call over ``iterations`` calls after a warm-up
    one: CUDA events on the card, the host clock on the CPU."""
    from bsmr_sddmm_tpu_torch.utils.timing import time_cuda, time_host
    if device.type != "cuda":
        return time_host(fn, *args, iterations=iterations)[0]
    with torch.cuda.device(device):
        return time_cuda(fn, *args, iterations=iterations)[0]


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
    ap.add_argument("--train", action="store_true")
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
    else:
        # the processes share the host's cores: with a full set of threads
        # each, one process's idle threads spin while it waits in a
        # collective and starve the others (a train step 40x slower)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.nproc))
    distributed.initialize(f"localhost:{args.port}", args.nproc, args.pid,
                           backend=_backend(args.backend, device, args.nproc))
    try:
        mesh = make_mesh(devices=[device, device])
        if mesh.size != 2 * args.nproc:
            raise RuntimeError(f"mesh of {mesh.size} shards, expected "
                               f"{2 * args.nproc}")
        backend = dist.get_backend()
        head = {"process": args.pid, "num_processes": dist.get_world_size(),
                "global_devices": mesh.size, "device": str(device),
                "backend": backend,
                "host_staged": device.type == "cuda" and backend == "gloo"}
        if args.train:
            rec = dict(head, train=True, **_train(args.matrix, mesh, device))
            print(json.dumps(rec), flush=True)
            return 0 if rec["check"] == "pass" else 1
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
        print(json.dumps(dict(
            head, shards=len(plans), nnz=int(csr.nnz),
            plan_hash=plan_hash(list(plans) + [rplan]),
            b_sharded_all_gather=True,
            check="pass" if res.passed else "fail",
            error_rate=float(res.error_rate),
            ring_check="pass" if res_ring.passed else "fail",
            ring_error_rate=float(res_ring.error_rate),
            sharded_ms=sharded_ms, ring_ms=ring_ms, timed_calls=ITERATIONS,
            sharded_counts=sharded_counts, ring_counts=ring_counts)),
            flush=True)
        return 0 if res.passed and res_ring.passed else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
