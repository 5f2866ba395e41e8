"""The collectives of the parallel layer, and their counters.

The JAX package never names a collective outside its bodies: ``shard_map``
hands every device its shard, ``jax.lax.all_gather`` and ``ppermute`` move
B inside the mapped body, and GSPMD inserts the gather that CSR emission
implies. Here each of them is one function over a mesh
(:class:`bsmr_sddmm_tpu_torch.parallel.sharding.Mesh`: this process's
shards' devices, in shard order, and the process's place among
``world_size`` processes). A list argument or result holds one tensor per
shard this process owns, each on its shard's device.

* :func:`all_gather`: every owned shard receives the concatenation, along
  dim 0, of every shard's tensor (the b-sharded layout's gather of B);
* :func:`ring_shift`: one hop of the ring, shard d receiving the tensor of
  shard (d + 1) % n (the ring's ``ppermute``);
* :func:`csr_gather`: the tier arrays of every shard laid out tier-major,
  shard-major, and read along a map: the CSR emission's gather;
* :func:`to_shards` and :func:`from_shards`: the two ends of the sharded
  train step (``models._common.SparseAttentionNet``), which autograd
  differentiates: a replicated tensor handed to every shard (backward: the
  sum of the shards' gradients) and the sum of the shards' partial
  results, replicated (backward: the same gradient to every shard). They
  stand for what GSPMD inserts around the JAX package's
  ``shard_device_plan`` train step (``models.*.make_train_step``).

Inside one process these are tensor copies between the mesh's devices (no
copy where two shards share a device). Across processes they go through
``torch.distributed``: ``all_gather_into_tensor`` for the gathers, and for
the ring one ``batch_isend_irecv`` pair per process and hop (only the
boundary shard crosses the process boundary; the send and the receive are
posted together, so the ring cannot deadlock), and for the train step's
two ends one ``all_reduce``, in ``from_shards``' forward and in
``to_shards``' backward: ``torch.distributed`` collectives carry no
gradient, so both are autograd functions, and every process ends a
backward with the same parameter gradients (no parameter all-reduce). On
the ``gloo`` backend a CUDA tensor is staged through host memory (gloo
moves host buffers); ``nccl`` moves device memory and needs a card of its
own per process.

Each call adds to :data:`COUNTS`: calls per operation, shard hops (one per
owned shard and ring hop), the cross-process ``all_reduce`` calls (forward
and backward) and the bytes this process received from other processes
(``world_size - 1`` times the buffer for a gather or an all-reduce).
:func:`zero_counts` and :func:`read_counts` reset and read them, as
``dense_kernels``' launch counters are reset and read.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

#: calls per operation, shard hops and bytes received from other processes
COUNTS = dict(all_gather=0, ring_shift=0, csr_gather=0, shard_hops=0,
              to_shards=0, from_shards=0, all_reduce=0,
              cross_process_bytes=0)


def zero_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def read_counts() -> dict:
    return dict(COUNTS)


def _dist():
    import torch.distributed as dist
    return dist


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor as the process group moves it: on gloo a CUDA tensor is
    copied to host memory first (the staging), else the tensor itself."""
    t = t.contiguous()
    return t.cpu() if t.is_cuda and _dist().get_backend() == "gloo" else t


def _gather_processes(mine: torch.Tensor, mesh) -> torch.Tensor:
    """``mine`` of every process, concatenated along dim 0 in process
    order (one ``all_gather_into_tensor``), on ``mine``'s device."""
    send = _wire(mine)
    full = send.new_empty((mesh.world_size * send.shape[0],)
                          + tuple(send.shape[1:]))
    _dist().all_gather_into_tensor(full, send)
    COUNTS["cross_process_bytes"] += (mesh.world_size - 1) * send.nbytes
    return full.to(mine.device)


def per_device(make, devices: Sequence[torch.device]) -> list:
    """``make(device)`` for each device, made once per distinct device
    (shards on one device share it)."""
    made = {}
    return [made[d] if d in made else made.setdefault(d, make(d))
            for d in devices]


def all_gather(parts: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Every owned shard's copy of all ``mesh.size`` shards' tensors,
    concatenated along dim 0 in shard order. ``parts`` holds the owned
    shards' tensors, all of one shape."""
    COUNTS["all_gather"] += 1
    if mesh.world_size > 1:
        mine = torch.cat([p.to(parts[0].device) for p in parts])
        full = _gather_processes(mine, mesh)
        return per_device(full.to, mesh.devices)
    return per_device(lambda d: torch.cat([p.to(d) for p in parts]),
                      mesh.devices)


def ring_shift(parts: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """One ring hop: the tensor each owned shard d holds afterwards is the
    one shard (d + 1) % mesh.size held before, on d's device."""
    COUNTS["ring_shift"] += 1
    COUNTS["shard_hops"] += len(parts)
    devs = mesh.devices
    out = [parts[i + 1].to(devs[i]) for i in range(len(parts) - 1)]
    if mesh.world_size == 1:
        return out + [parts[0].to(devs[-1])]
    dist = _dist()
    W, r = mesh.world_size, mesh.rank
    send = _wire(parts[0])
    recv = torch.empty_like(send)
    # the first owned shard goes to the last shard of the process before;
    # the last owned shard receives the first shard of the process after
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, (r - 1) % W),
        dist.P2POp(dist.irecv, recv, (r + 1) % W)])
    for req in reqs:
        req.wait()
    COUNTS["cross_process_bytes"] += recv.nbytes
    return out + [recv.to(devs[-1])]


def csr_gather(tiers: Sequence[Sequence[torch.Tensor]],
               index: torch.Tensor, mesh) -> torch.Tensor:
    """The values ``big[index]`` of ``big``, the concatenation of every
    shard's tier arrays, tier-major and shard-major: ``[tier0 of shard 0,
    ..., tier0 of shard n-1, tier1 of shard 0, ...]``, each array
    flattened. ``tiers[t][j]`` is tier t of the j-th owned shard (one
    shape per tier over all shards). The result is on the first owned
    shard's device, in every process."""
    COUNTS["csr_gather"] += 1
    dev = mesh.devices[0]
    if mesh.world_size == 1:     # one copy of every array, in order
        return torch.cat([a.reshape(-1).to(dev) for tier in tiers
                          for a in tier]).index_select(0, index)
    # one gather of each process's [tier0 | tier1 | ...], then the
    # tier-major order: tier t of every process in turn
    flat = [torch.cat([a.reshape(-1).to(dev) for a in tier])
            for tier in tiers]
    lens = [f.numel() for f in flat]
    full = _gather_processes(torch.cat(flat), mesh).view(mesh.world_size, -1)
    return torch.cat([piece.reshape(-1) for piece in full.split(lens, dim=1)]
                     ).index_select(0, index)


def _all_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over every process (one ``all_reduce``), as a new
    tensor on ``t``'s device."""
    send = _wire(t.detach())
    buf = send.clone() if send.data_ptr() == t.data_ptr() else send
    _dist().all_reduce(buf)
    COUNTS["all_reduce"] += 1
    COUNTS["cross_process_bytes"] += (mesh.world_size - 1) * buf.nbytes
    return buf.to(t.device)


class _SumForward(torch.autograd.Function):
    """Forward: the sum over processes; backward: the gradient as it is
    (every process holds the same gradient of the replicated sum)."""

    @staticmethod
    def forward(ctx, t, mesh):
        return _all_reduce(t, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumBackward(torch.autograd.Function):
    """Forward: the tensor as it is; backward: the sum of the gradients
    over processes (each process holds its own shards' share)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous(), ctx.mesh), None


def to_shards(x: torch.Tensor, mesh) -> List[torch.Tensor]:
    """The replicated ``x`` on each owned shard's device (one copy a
    device, shared by its shards). Backward: the sum of every shard's
    gradient, over this process's shards (autograd sums the copies) and
    across processes (one ``all_reduce``)."""
    COUNTS["to_shards"] += 1
    if mesh.world_size > 1:
        x = _SumBackward.apply(x, mesh)
    return per_device(x.to, mesh.devices)


def from_shards(parts: Sequence[torch.Tensor], mesh,
                device: torch.device) -> torch.Tensor:
    """The sum of every shard's tensor (``parts`` holds the owned shards'
    tensors, all of one shape), replicated: on ``device`` in every
    process. Backward: the same gradient to every shard."""
    COUNTS["from_shards"] += 1
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    if mesh.world_size > 1:
        total = _SumForward.apply(total, mesh)
    return total
