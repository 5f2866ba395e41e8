"""Two processes run the port's sharded SDDMM together (the counterpart of
tests/test_multihost.py): each bootstraps with
``parallel.distributed.initialize`` on ``gloo``, owns 2 CPU shards of one
4-shard mesh, and runs ``python -m bsmr_sddmm_tpu_torch.parallel.worker``:
the b-sharded all-gather and every ring hop cross the process boundary.
Both processes check both full outputs against the fp64 oracle (check_data:
abs 1e-5 OR rel 1e-3) and must have packed the same plans.

With ``--train`` the two processes take three Adam steps of the graph
transformer together: both must end with the same parameters (one hash),
and their losses must equal those of the same steps over a 4-shard mesh
in one process within 1e-6 (a row is summed from one shard only, so the
forward is exact; k's and v's gradients are summed in another order)."""

import json
import os
import socket
import subprocess
import sys

import _torch_threads  # noqa: F401  (this worker's thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(*extra) -> list:
    """Two worker processes on gloo with 2 CPU shards each: their JSON
    lines."""
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bsmr_sddmm_tpu_torch.parallel.worker",
         str(pid), "2", port, "--device", "cpu", "--backend", "gloo",
         *extra],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for pid in range(2)]
    recs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            recs.append(json.loads([ln for ln in out.splitlines()
                                    if ln.startswith("{")][-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return recs


def test_two_process_sharded_sddmm_on_gloo():
    recs = run_workers()
    for pid, rec in enumerate(recs):
        assert rec["process"] == pid
        assert rec["check"] == "pass" and rec["ring_check"] == "pass"
        assert rec["global_devices"] == 4 and rec["shards"] == 4
        assert rec["num_processes"] == 2 and rec["backend"] == "gloo"
        sc, rc = rec["sharded_counts"], rec["ring_counts"]
        assert (sc["all_gather"], sc["csr_gather"], sc["ring_shift"]) == \
            (1, 1, 0)
        assert (rc["ring_shift"], rc["shard_hops"], rc["all_gather"]) == \
            (3, 6, 0)
        assert sc["cross_process_bytes"] > 0 and rc["cross_process_bytes"] > 0
    assert recs[0]["plan_hash"] == recs[1]["plan_hash"]


def test_two_process_train_steps_on_gloo():
    import numpy as np
    import torch

    from bsmr_sddmm_tpu_torch.models import graph_transformer as gt
    from bsmr_sddmm_tpu_torch.parallel import make_mesh, worker
    recs = run_workers("--train")
    for pid, rec in enumerate(recs):
        assert rec["process"] == pid and rec["train"] is True
        assert rec["check"] == "pass" and rec["shards"] == 4
        assert rec["global_devices"] == 4 and rec["num_processes"] == 2
        c = rec["counts"]
        steps, layers = worker.TRAIN_STEPS, 2
        # one to_shards and one from_shards a layer and step; each
        # all-reduces once across the processes (forward or backward)
        assert c["to_shards"] == c["from_shards"] == steps * layers
        assert c["all_reduce"] == 2 * steps * layers
        assert c["cross_process_bytes"] > 0
        assert len(rec["losses"]) == steps
    assert recs[0]["param_hash"] == recs[1]["param_hash"]
    assert recs[0]["losses"] == recs[1]["losses"]
    assert recs[0]["plan_hash"] == recs[1]["plan_hash"]
    # the same steps over 4 shards in one process
    csr, cfg, model, X, labels = worker.train_problem(None)
    net, dplan, _ = gt.make_forward(model, csr, cfg,
                                    mesh=make_mesh(devices=["cpu"] * 4))
    opt_init, step = gt.make_train_step(model, net, worker.TRAIN_LR)
    opt = opt_init()
    X, labels = torch.from_numpy(X), torch.from_numpy(labels)
    losses = [float(step(opt, X, labels, dplan))
              for _ in range(worker.TRAIN_STEPS)]
    np.testing.assert_allclose(recs[0]["losses"], losses, rtol=0, atol=1e-6)


def test_worker_defaults_take_the_card(monkeypatch):
    """With no --device the worker takes card pid % cards and raises where
    none is visible; the backend follows the device: nccl where every
    process has a card of its own, else gloo."""
    import pytest
    import torch

    from bsmr_sddmm_tpu_torch.parallel import worker
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        worker._device(None, 0)
    assert worker._device("cpu", 1) == torch.device("cpu")
    assert worker._backend(None, torch.device("cpu"), 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert worker._device(None, 3) == torch.device("cuda:1")
    assert worker._backend(None, torch.device("cuda:1"), 2) == "nccl"
    assert worker._backend(None, torch.device("cuda:0"), 4) == "gloo"
    assert worker._backend("gloo", torch.device("cuda:0"), 2) == "gloo"
