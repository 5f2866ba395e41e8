"""Multi-device SDDMM: row-panel sharding over a mesh of devices.

The counterpart of ``bsmr_sddmm_tpu.parallel.sharding``. The row panels of
the reordered mask are split into contiguous, cost-balanced ranges, each
range is packed *independently* (``pack.pack_shard_plans``) so that every
shard keeps fat dense steps and its own gathered/residual tiers, and each
shard runs the full hybrid body, and so the hand kernels of
``ops/dense_kernels.py``, on its own device.

Where the JAX package has a ``jax.sharding.Mesh`` and ``shard_map``, this
package has a :class:`Mesh` (the ordered devices of the shards this
process owns, and the process's place among ``torch.distributed``'s
processes) and a Python loop over the owned shards. A sharded operand or
result is a list with one tensor per owned shard, each on its shard's
device; the collectives are the three functions of
:mod:`bsmr_sddmm_tpu_torch.parallel.collectives`. Shards are owned
process-major, as in JAX's global mesh: with W processes of L shards
each, process p owns shards ``[p*L, (p+1)*L)``.

The hot path has NO combine step: the natural output of the sharded SDDMM
is the sharded rphm layout (each shard holds its own panels' tiles).
CSR-order emission is one gather along a precomputed global map.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.formats import CSR
from bsmr_sddmm_tpu_torch.ops.sddmm import (DevicePlan, device_plan,
                                            make_sddmm_body)
from bsmr_sddmm_tpu_torch.pack import TilePlan, pack_shard_plans
from bsmr_sddmm_tpu_torch.parallel import collectives
from bsmr_sddmm_tpu_torch.reorder import BsmrReordering

AXIS = "panels"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the row-panel axis: ``devices`` holds the device of
    each shard this process owns, in shard order (one device may hold
    several shards); the mesh has ``world_size * len(devices)`` shards,
    of which process ``rank`` owns ``[rank*L, (rank+1)*L)``."""

    devices: Tuple[torch.device, ...]
    world_size: int = 1
    rank: int = 0
    axis_names: ClassVar[Tuple[str, ...]] = (AXIS,)

    @property
    def size(self) -> int:
        return self.world_size * len(self.devices)

    @property
    def owned(self) -> range:
        L = len(self.devices)
        return range(self.rank * L, (self.rank + 1) * L)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of this process's shards: the first ``n_devices`` of
    ``devices`` (all of them by default), or of the visible cards
    ``cuda:0..`` when ``devices`` is None. A device may repeat (shards
    sharing a card, or ``["cpu"] * 8`` for a CPU mesh). Asked for more
    cards or devices than there are, it raises. In a run of several
    processes (``torch.distributed`` initialised) every process passes its
    own devices, and the mesh spans all processes' shards."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices (e.g. ['cpu'] * n)"
                " to build a mesh on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(devices)} available: {devices}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    world_size, rank = 1, 0
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        world_size, rank = dist.get_world_size(), dist.get_rank()
    return Mesh(tuple(devices), world_size, rank)


def put_global(arr, mesh: Mesh, sharded: bool = False) -> List[torch.Tensor]:
    """Place a host array (NumPy or tensor; every process holds the full
    value, as plans are packed deterministically everywhere) on the
    mesh: one tensor per owned shard, on its device. Replicated, each
    device gets one copy, shared by its shards; ``sharded``, the leading
    dim is split into ``mesh.size`` equal parts and shard s gets part s."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    if not sharded:
        return collectives.per_device(t.to, mesh.devices)
    n = mesh.size
    if t.shape[0] % n:
        raise ValueError(f"cannot split {t.shape[0]} rows over {n} shards")
    rows = t.shape[0] // n
    return [t[s * rows:(s + 1) * rows].to(d).contiguous()
            for s, d in zip(mesh.owned, mesh.devices)]


def _pad_leading(arr: np.ndarray, mult: int, fill) -> np.ndarray:
    n = arr.shape[0]
    target = -(-n // mult) * mult
    if target == n:
        return arr
    pad = np.full((target - n,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def shard_device_plan(plan: TilePlan, mesh: Mesh) -> List[DevicePlan]:
    """Shard a single global plan's arrays: leading dims split evenly over
    the mesh (after padding to a multiple of its size), permutation and
    emission maps replicated; one DevicePlan per owned shard, on its
    device. This is the data-parallel split of the JAX package's
    ``shard_device_plan`` (there a GSPMD annotation, under which the JAX
    models' ``make_train_step`` is partitioned); nothing here executes on
    it, because it cuts rows across shards and, when the mesh size does
    not divide the fat steps, pads ``tile_panel`` and ``tile_src`` apart.
    The multi-device execution paths run on per-shard packed plans
    instead: :func:`make_sharded_sddmm` for the SDDMM, and for training
    ``models.*.make_forward(..., mesh=)`` (``models._common``)."""
    n = mesh.size
    if plan.mode != "bsr":
        tile_src = plan.tile_cols
    elif plan.fat_group > 1:
        tile_src = plan.step_cblock
    else:
        tile_src = plan.tile_cblock

    def split(arr, fill):
        arr = np.ascontiguousarray(_pad_leading(arr, n, fill), np.int32)
        return put_global(arr, mesh, sharded=True)

    def repl(arr):
        return put_global(np.ascontiguousarray(arr, np.int32), mesh)

    nnz = plan.nnz
    fields = dict(
        row_perm_padded=repl(plan.row_perm_padded),
        tile_panel=split(plan.tile_panel, 0),
        tile_src=split(tile_src, 0),
        tile_scatter=split(plan.tile_scatter, nnz),
        sp_panel=split(plan.sp_panel, 0),
        sp_sub=split(plan.sp_sub, 0),
        sp_scatter=split(plan.sp_scatter, nnz),
        sp_colperm=repl(plan.sp_colperm),
        g_panel=split(plan.g_panel, 0),
        g_cols=split(plan.g_cols, max(plan.cols - 1, 0)),
        g_scatter=split(plan.g_scatter, nnz),
        res_arow=split(plan.res_arow, 0),
        res_col=split(plan.res_col, 0),
        res_out=split(plan.res_out, nnz),
        rphm_to_csr=repl(plan.rphm_to_csr),
    )
    return [DevicePlan(**{name: parts[j] for name, parts in fields.items()})
            for j in range(len(mesh.devices))]


def shard_operands(A, Bt, mesh: Mesh, b_sharded: bool = False):
    """Place the dense operands for the sharded SDDMM: A is replicated
    (every shard owns whole row panels of the mask and needs its own A
    rows); Bt is either replicated or row-sharded (= column panels of B)
    for the all-gather path. Each is a list over the owned shards."""
    if b_sharded and Bt.shape[0] % mesh.size:
        raise ValueError(
            f"b_sharded needs N ({Bt.shape[0]}) divisible by the mesh "
            f"size ({mesh.size}); pad B's columns first")
    return put_global(A, mesh), put_global(Bt, mesh, sharded=b_sharded)


def sharded_rphm_to_csr(plans) -> np.ndarray:
    """Global map: CSR value index -> offset in the stacked sharded rphm
    layout ``concat(dense_all.ravel(), packed_all.ravel(),
    gathered_all.ravel(), res_all)``, each tier stacked shard-major.
    Every CSR index is owned by exactly one shard (panels partition
    rows), so the map is a bijection onto a subset of slots."""
    nnz = plans[0].nnz
    n = len(plans)
    ph, bw = plans[0].panel_height, plans[0].block_width
    T = plans[0].tile_panel.shape[0]
    Tp = plans[0].sp_panel.shape[0]
    Tg = plans[0].g_panel.shape[0]
    E = plans[0].res_arow.shape[0]
    base_p = n * T * ph * bw
    base_g = base_p + n * Tp * ph * bw
    base_r = base_g + n * Tg * ph * bw
    if base_r + n * E >= np.iinfo(np.int32).max:
        raise ValueError("sharded rphm layout exceeds int32 indexing")
    out = np.zeros(nnz, np.int64)
    for s, p in enumerate(plans):
        ts = p.tile_scatter.reshape(-1)
        m = ts < nnz
        out[ts[m]] = np.nonzero(m)[0] + s * T * ph * bw
        sp = p.sp_scatter.reshape(-1)
        m = sp < nnz
        out[sp[m]] = np.nonzero(m)[0] + base_p + s * Tp * ph * bw
        gs = p.g_scatter.reshape(-1)
        m = gs < nnz
        out[gs[m]] = np.nonzero(m)[0] + base_g + s * Tg * ph * bw
        m = p.res_out < nnz
        out[p.res_out[m]] = np.nonzero(m)[0] + base_r + s * E
    return out.astype(np.int32)


def make_sharded_sddmm(csr: CSR, reord: BsmrReordering,
                       config: SddmmConfig, mesh: Mesh,
                       k: Optional[int] = None,
                       backend: Optional[str] = None,
                       b_sharded: bool = False,
                       emit: str = "rphm"
                       ) -> Tuple[Callable, List[DevicePlan], list]:
    """Build the sharded hybrid SDDMM.

    Returns ``(fn, dplan, shard_plans)`` with ``fn(A, Bt, dplan)``, where
    A and Bt are :func:`shard_operands`' lists and ``dplan`` holds one
    DevicePlan per owned shard, on its device:

    * ``emit="rphm"`` (the hot path): each shard computes its own panels'
      dense/packed/gathered/residual outputs — fat steps intact, zero
      collectives with replicated operands (one :func:`collectives.
      all_gather` of B when ``b_sharded``). Returns the four tiers, each
      a list over the owned shards of the arrays where they were made.
    * ``emit="csr"``: the rphm outputs flow through one gather along the
      precomputed global map (:func:`sharded_rphm_to_csr`) and come back
      in original CSR value order, in every process.

    One body, built from ``shard_plans[0]``, serves every shard: the
    shard packer pads all shards to common shapes and one window grid.
    ``backend`` is the body's (hand kernels on CUDA tensors by default).
    """
    if emit not in ("rphm", "csr"):
        raise ValueError(f"unknown emit {emit!r}")
    plans = pack_shard_plans(csr, reord, config, mesh.size, k=k)
    dplan = [device_plan(plans[s], dev, emit="rphm")
             for s, dev in zip(mesh.owned, mesh.devices)]
    body = make_sddmm_body(plans[0], config, backend, emit="rphm")

    def rphm(A, Bt, dplan):
        if b_sharded:
            # (N/n, K) shards -> full (N, K) on every shard: one gather
            Bt = collectives.all_gather(Bt, mesh)
        outs = [body(a, b, d) for a, b, d in zip(A, Bt, dplan)]
        return tuple(list(tier) for tier in zip(*outs))

    if emit == "rphm":
        return rphm, dplan, plans

    csr_map = torch.from_numpy(sharded_rphm_to_csr(plans)).to(
        mesh.devices[0])

    def fn(A, Bt, dplan):
        return collectives.csr_gather(rphm(A, Bt, dplan), csr_map, mesh)

    return fn, dplan, plans
