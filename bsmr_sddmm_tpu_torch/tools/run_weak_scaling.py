"""Weak scaling of the real sharded SDDMM: the port of
``scripts/run_weak_scaling.py``.

    python -m bsmr_sddmm_tpu_torch.tools.run_weak_scaling \
        [--counts 1 2 4 8] [--out build/weak_scaling.json] [--device cpu]

A thin wrapper over ``parallel.distributed.sddmm_weak_scaling`` at the JAX
script's sizes (4096 rows and 250 000 nonzeros a shard, 8192 columns, K=64,
band 128, 4 timed calls). The shards lie on ``make_mesh`` devices: one card
each where enough cards are visible, else every shard on the first card,
run one after another (the structure, not a scaling figure); with
``--device cpu`` on CPU devices (host times, not device metrics). What the
run shows either way: per-shard shapes stay constant as the mesh grows, and
the replicated-B path adds no collective.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Sequence

import torch

from bsmr_sddmm_tpu_torch.ops.sddmm import resolve_device
from bsmr_sddmm_tpu_torch.tools import add_device_arg


def mesh_devices(device: torch.device, n: int) -> List[str]:
    """``n`` shard devices: a card each where ``n`` are visible, else the
    first card (or the CPU) repeated."""
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return [str(device if device.type == "cpu"
                else torch.device("cuda", 0))] * n


def run(counts: Sequence[int], device: torch.device) -> dict:
    """The weak-scaling payload: per count, ms, nnz/s, efficiency and the
    shard shapes."""
    from bsmr_sddmm_tpu_torch.config import SddmmConfig
    from bsmr_sddmm_tpu_torch.parallel import distributed

    devices = mesh_devices(device, max(counts))
    cfg = SddmmConfig(k=64, panel_height=32)
    res = distributed.sddmm_weak_scaling(
        counts, rows_per_device=4096, nnz_per_device=250_000,
        cols=8192, k=64, bandwidth=128, config=cfg, iterations=4,
        devices=devices)
    shared = len(set(devices)) == 1 and len(devices) > 1
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {
        "metric": "weak_scaling",
        "device": name,
        "devices": devices,
        "host_cores": os.cpu_count(),
        "note": (("every shard on one device, run one after another: the "
                  "times are serial work, not scaling. " if shared else "")
                 + ("CPU host times, not device metrics. "
                    if device.type == "cpu" else "")
                 + "Constant per-shard shapes and no hot-path collective "
                   "are the structural evidence."),
        "per_device": {str(n): {k: (v if k == "shard_shapes" else float(v))
                                for k, v in d.items()}
                       for n, d in res.items()},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="weak scaling of the sharded SDDMM")
    p.add_argument("--counts", type=int, nargs="*", default=[1, 2, 4, 8])
    p.add_argument("--out", default=os.path.join("build",
                                                 "weak_scaling.json"))
    add_device_arg(p)
    args = p.parse_args(argv)
    payload = run(args.counts, resolve_device(args.device))
    print(json.dumps(payload, indent=1))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
