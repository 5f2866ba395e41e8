"""The graft entry points on PyTorch: the counterpart of
``__graft_entry__.py``.

``entry()``             -> (fn, example_args): the forward of the flagship
                           graph transformer on a tiny packed mask.
``dryrun_multichip(n)`` -> one full Adam step of that model over an n-shard
                           mesh, then the per-shard-packed sharded SDDMM
                           (B replicated and B column-panel sharded,
                           ``emit="csr"`` and ``emit="rphm"``) and the
                           B-panel ring, every output checked against the
                           fp64 oracle.

    python -m bsmr_sddmm_tpu_torch.graft_entry     # on the card

runs ``entry()``'s forward and ``dryrun_multichip(8)``, as ``python
__graft_entry__.py`` does on a virtual 8-device CPU mesh. Both functions run
on the card unless the caller names the CPU (``entry(device="cpu")``,
``dryrun_multichip(n, devices=["cpu"] * n)``); with no card and nothing
named they raise. The hand kernels run wherever the tensors are on the card:
``bsr_dense`` and ``subpack`` in every shard's attention head and sharded
SDDMM body, ``bsr_dense`` and ``dense_tile`` in the ring.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR, make_dense, random_mask
from bsmr_sddmm_tpu_torch.models.graph_transformer import (GraphTransformer,
                                                           init_params,
                                                           make_forward,
                                                           make_train_step)
from bsmr_sddmm_tpu_torch.ops.sddmm import resolve_device, sddmm_ref
from bsmr_sddmm_tpu_torch.parallel.ring import make_ring_sddmm, ring_operands
from bsmr_sddmm_tpu_torch.parallel.sharding import (make_mesh,
                                                    make_sharded_sddmm,
                                                    shard_operands,
                                                    sharded_rphm_to_csr)
from bsmr_sddmm_tpu_torch.reorder import bsmr
from bsmr_sddmm_tpu_torch.utils.checkdata import check_data

#: the model's input width and classes, as the JAX entry points build it
FEATURE_DIM, NUM_HEADS, NUM_CLASSES = 16, 2, 4


def _tiny_problem(k=32, rows=256, cols=256, nnz=6000, seed=5
                  ) -> Tuple[CSR, SddmmConfig]:
    """The JAX file's ``_tiny_problem``: the same mask and config."""
    csr = random_mask(rows, cols, nnz, seed=seed,
                      block_rows=16, block_cols=64)
    cfg = SddmmConfig(k=k, panel_height=16, dense_chunk=16,
                      residual_chunk=2048)
    return csr, cfg


def _model(csr: CSR, cfg: SddmmConfig, num_layers: int) -> GraphTransformer:
    return GraphTransformer(num_nodes=csr.rows, feature_dim=FEATURE_DIM,
                            head_dim=cfg.k, num_heads=NUM_HEADS,
                            num_layers=num_layers, num_classes=NUM_CLASSES)


def _features(rows: int) -> np.ndarray:
    return np.random.default_rng(0).normal(
        0, 1, (rows, FEATURE_DIM)).astype(np.float32)


def _flat(params: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested params dict as the module's dotted parameter names."""
    out = {}
    for name, value in params.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = value
    return out


def entry(*, device=None, problem: Optional[Tuple[CSR, SddmmConfig]] = None):
    """``(fn, (params, X, dplan))``: ``fn(params, X, dplan)`` is the graph
    transformer's forward (2 heads, 2 layers, 4 classes, ``head_dim`` the
    config's k) on the mask's packed plan, and returns the ``(rows, 4)``
    logits; ``params`` is ``init_params``' nested dict, which ``fn`` swaps
    into the net (``torch.func.functional_call``), as the JAX function's
    ``fn`` takes its params pytree. Mirrors ``__graft_entry__.entry``.

    ``device``: the card by default (``ops.sddmm.resolve_device``: no card
    raises unless the CPU is named). ``problem=(csr, cfg)`` replaces
    ``_tiny_problem()``; a cfg with ``backend="torch"`` builds the same
    forward on the kernels' plain versions."""
    device = resolve_device(device)
    csr, cfg = problem or _tiny_problem()
    model = _model(csr, cfg, num_layers=2)
    net, dplan, _ = make_forward(model, csr, cfg, device=device)
    params = {name: ({k: v.to(device) for k, v in value.items()}
                     if isinstance(value, dict) else value.to(device))
              for name, value in init_params(model).items()}
    X = torch.from_numpy(_features(csr.rows)).to(device)

    def fn(params, X, dplan):
        return torch.func.functional_call(net, _flat(params), (X, dplan))

    return fn, (params, X, dplan)


def _shard_devices(n_devices: int,
                   devices: Optional[Sequence]) -> List[torch.device]:
    """``devices`` (default: the visible cards) cycled to ``n_devices``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=['cpu'] * n to run the "
                "dry run's shards on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("dryrun_multichip: no devices")
    return [devices[i % len(devices)] for i in range(n_devices)]


def _timed(fn, devices):
    """``fn()`` and its milliseconds of host wall time, every card of
    ``devices`` synchronised before and after."""
    cards = sorted({str(d) for d in devices if d.type == "cuda"})

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, 1e3 * (time.perf_counter() - t0)


def _checked(oracle: np.ndarray, out: torch.Tensor, what: str) -> float:
    """check_data of ``out`` against the oracle; raises where it fails."""
    if tuple(out.shape) != oracle.shape:
        raise AssertionError(f"{what}: shape {tuple(out.shape)}, want "
                             f"{oracle.shape}")
    res = check_data(oracle, out.float().cpu().numpy())
    if not res.passed:
        raise AssertionError(f"{what} vs oracle: {res}")
    return res.error_rate


def dryrun_multichip(n_devices: int, *, devices: Optional[Sequence] = None,
                     problem: Optional[Tuple[CSR, SddmmConfig]] = None,
                     params: Optional[Dict] = None) -> dict:
    """Mirrors ``__graft_entry__.dryrun_multichip``, in its three parts and
    their order, on an ``n_devices``-shard mesh:

    1. one Adam step of the graph transformer (16 features, ``head_dim``
       the config's k, 2 heads, 1 layer, 4 classes) built with
       ``make_forward(..., mesh=)``: each shard runs its own packed plan,
       head and device plan (``models._common``), where the JAX function
       hands its jitted step ``shard_device_plan``'s plan (the two steps
       are held equal in tests/test_torch_train_sharded.py). The loss must
       be finite;
    2. ``make_sharded_sddmm`` with ``shard_operands``, B replicated and
       B-sharded: ``emit="csr"``, and ``emit="rphm"`` read back through
       ``sharded_rphm_to_csr`` (the JAX function checks only the rphm
       arrays' ranks), each held to the fp64 oracle ``sddmm_ref`` by
       ``check_data``;
    3. the B-panel ring, ``make_ring_sddmm(emit="csr")``, likewise.

    Prints the JAX function's summary line, to which it adds the rphm
    error rates, the devices, and the milliseconds of each call (host wall
    time, the cards synchronised around the one call). Returns ``{"loss",
    "error_rates", "outputs" (each SDDMM output as a NumPy array in CSR
    order), "ms", "devices"}``; the JAX function returns None.

    Two differences from the JAX function, both deliberate:

    * ``devices``: the shards' devices, default the visible cards, cycled
      to ``n_devices`` (a card may hold several shards; one card holds all
      eight of ``dryrun_multichip(8)`` on a one-card machine). With no card
      and no ``devices`` it raises: it never carries on on the CPU.
    * ``problem=(csr, cfg)`` replaces ``_tiny_problem()``, so that the same
      path runs at full width; a cfg with ``backend="torch"`` builds every
      part on the kernels' plain versions.

    ``params`` (``init_params``' layout) replaces ``init_params(model)``."""
    t_start = time.perf_counter()
    devs = _shard_devices(n_devices, devices)
    mesh = make_mesh(devices=devs)
    dev0 = mesh.devices[0]
    csr, cfg = problem or _tiny_problem()
    ms: Dict[str, float] = {}

    # --- 1. the full training step over the mesh --------------------------
    model = _model(csr, cfg, num_layers=1)
    net, dplan, _ = make_forward(model, csr, cfg, params=params, mesh=mesh)
    opt_init, train_step = make_train_step(model, net)
    opt = opt_init()
    X = torch.from_numpy(_features(csr.rows)).to(dev0)
    labels = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.num_classes, csr.rows)).to(dev0)
    loss, ms["train_step"] = _timed(
        lambda: train_step(opt, X, labels, dplan), devs)
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    del net, opt, dplan

    # --- 2. the per-shard-packed sharded SDDMM ----------------------------
    reord = bsmr(csr, cfg)
    A = make_dense(csr.rows, cfg.k)
    Bt = make_dense(csr.cols, cfg.k, seed=99)
    oracle = sddmm_ref(A, Bt.T, csr)
    rates: Dict[str, float] = {}
    outputs: Dict[str, np.ndarray] = {}

    def keep(key, out, what):
        rates[key] = _checked(oracle, out, what)
        outputs[key] = out.cpu().numpy()

    for b_sharded in (False, True):
        fn, dplan2, _ = make_sharded_sddmm(
            csr, reord, cfg, mesh, b_sharded=b_sharded, emit="csr")
        A_dev, Bt_dev = shard_operands(A, Bt, mesh, b_sharded=b_sharded)
        key = f"allgather_b{int(b_sharded)}"
        out, ms[key] = _timed(lambda: fn(A_dev, Bt_dev, dplan2), devs)
        keep(key, out, f"sharded sddmm (b_sharded={b_sharded})")
        # the hot path: the sharded rphm tiers, each a list over shards
        fn_r, dplan3, plans = make_sharded_sddmm(
            csr, reord, cfg, mesh, b_sharded=b_sharded, emit="rphm")
        key = f"rphm_b{int(b_sharded)}"
        tiers, ms[key] = _timed(lambda: fn_r(A_dev, Bt_dev, dplan3), devs)
        ranks = [[x.ndim for x in tier] for tier in tiers]
        if ranks != [[r] * n_devices for r in (3, 3, 3, 1)]:
            raise AssertionError(f"sharded rphm (b_sharded={b_sharded}): "
                                 f"tier ranks {ranks}")
        cmap = torch.from_numpy(sharded_rphm_to_csr(plans)).to(dev0)
        vals = torch.cat([torch.cat([x.reshape(-1).to(dev0) for x in tier])
                          for tier in tiers]).index_select(0, cmap)
        keep(key, vals, f"sharded rphm (b_sharded={b_sharded}) through "
                        f"sharded_rphm_to_csr")
        del fn, fn_r, dplan2, dplan3, tiers

    # --- 3. the B-panel ring (B stays sharded; n - 1 hops) ----------------
    fn_ring, rplan = make_ring_sddmm(csr, reord, cfg, mesh, emit="csr")
    A_r, Bt_r = ring_operands(A, Bt, rplan, mesh)
    out_ring, ms["ring"] = _timed(lambda: fn_ring(A_r, Bt_r), devs)
    keep("ring", out_ring, "ring sddmm")

    names = sorted({str(d) for d in devs})
    print(f"dryrun_multichip({n_devices}): train loss {loss:.4f}, "
          f"sddmm oracle-validated ({csr.nnz} nnz, per-shard-packed, "
          f"replicated + all-gathered + ring-rotated B; error_rate "
          + ", ".join(f"{k}={rates[k]:.1f}"
                      for k in ("allgather_b0", "allgather_b1", "ring"))
          + f"); rphm through sharded_rphm_to_csr error_rate "
          f"rphm_b0={rates['rphm_b0']:.1f}, rphm_b1={rates['rphm_b1']:.1f}; "
          f"{n_devices} shards on {len(names)} device(s) "
          f"({', '.join(names)}); ms a call " + ", ".join(
              f"{k} {v:.1f}" for k, v in ms.items())
          + f"; wall {time.perf_counter() - t_start:.1f} s", flush=True)
    return {"loss": loss, "error_rates": rates, "outputs": outputs,
            "ms": ms, "devices": [str(d) for d in devs]}


if __name__ == "__main__":
    fn, args = entry()
    with torch.no_grad():
        out = fn(*args)
    print("entry forward:", tuple(out.shape))
    dryrun_multichip(8)
