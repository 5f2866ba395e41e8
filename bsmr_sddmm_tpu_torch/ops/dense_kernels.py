"""Hand-written Hopper kernels of the SDDMM body's two tile tiers, their
wrappers and their plain PyTorch versions.

``bsr_dense`` (csrc/bsr_dense.cu) replaces the JAX package's Pallas kernels
``make_bsr_fat_kernel`` (bsmr_sddmm_tpu/ops/pallas_dense.py:419-480, G > 1)
and ``make_bsr_dense_kernel`` (:144-201, G = 1): one kernel, where tile t
reads column block ``step_cblock[t // G]``; a G = 1 plan passes its
``tile_cblock`` as ``step_cblock``. ``subpack`` (csrc/subpack.cu) replaces
``make_subpack_kernel`` (:261-327).

What bounds them on the card: a (ph x bw) = (32 x 128) tile at depth K reads
4*K*(32 + 128) bytes of operands and writes 4*32*128 bytes, for 2*32*128*K
flops: 7.1 flops per byte at K = 32, 10.7 at K = 128, never above 12.8,
while the card's fp32 rate over its memory bandwidth is about 20. At K = 32
the output store is nearly as large as the operand reads. Counted from
device memory, the tiers would be bound by memory traffic; in practice the
A panels and B blocks are re-read from L2 (tiles sorted by column block,
panels shared), and this first design is bound by its own inner loop: fp32
FFMA fed by shared-memory loads (PERF.md has the measured rates). The design
is simple and right: one thread block per tile, the A panel and the B block
staged through shared memory in K-chunks of 32, fp32 FFMA accumulation in
order over K (no TF32, so no rounding question), a 4x4 register tile per
thread (csrc/tile_matmul.cuh). It leaves for later: tensor cores (TF32 with
``cvt.rna`` rounding or 3xTF32, ``wgmma``), larger register tiles, reuse of
one B block across the G tiles of a fat step, TMA loads and persistent
blocks.

Each wrapper checks its inputs and then dispatches on the device of its
tensors: CPU tensors go to the plain version, CUDA tensors launch the
kernel on the current stream (no synchronisation) or raise. It counts its
launches in ``<wrapper>.launches``, a plain int that only a kernel launch
increments.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: Tile geometries (panel_height, block_width) the CUDA kernels are
#: instantiated for (BSMR_FOR_EACH_GEOMETRY in csrc/tile_matmul.cuh).
GEOMETRIES = frozenset((ph, bw) for ph in (8, 16, 32, 64) for bw in (128, 256))
_OUT_DTYPES = (torch.float32, torch.float16)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_operands(name, A_panels, B, index_pairs, out_dtype):
    _check(A_panels.dim() == 3 and B.dim() == 2
           and B.shape[1] == A_panels.shape[2],
           f"{name}: A_panels must be (P, ph, K) and B (rows, K), got "
           f"{tuple(A_panels.shape)} and {tuple(B.shape)}")
    _check(A_panels.dtype == torch.float32 and B.dtype == torch.float32,
           f"{name}: operands must be float32")
    _check(out_dtype in _OUT_DTYPES,
           f"{name}: out_dtype must be float32 or float16, got {out_dtype}")
    dev = A_panels.device
    for label, t in index_pairs:
        _check(t.dtype == torch.int32, f"{name}: {label} must be int32")
    for t in (B,) + tuple(t for _, t in index_pairs):
        _check(t.device == dev,
               f"{name}: all tensors must be on {dev}, got {t.device}")
    return dev


def _launch_args(dev: torch.device, tensors):
    if dev.type != "cuda":
        raise ValueError(f"kernels run on CUDA or CPU tensors, got {dev}")
    for t in tensors:
        _check(t.is_contiguous(), "kernel operands must be contiguous")
    return [t.data_ptr() for t in tensors]


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# Dense BSR tier
# ---------------------------------------------------------------------------

def bsr_dense_plain(A_panels: torch.Tensor, Bt: torch.Tensor,
                    tile_panel: torch.Tensor, step_cblock: torch.Tensor, *,
                    fat_group: int, block_width: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of :func:`bsr_dense`: ``out[t] = A_panels[tile_panel[t]]
    @ Bt[cb*bw : (cb+1)*bw].T`` with ``cb = step_cblock[t // fat_group]``,
    rows of Bt at or past N reading as zero. (T, ph, bw)."""
    bw, k = block_width, Bt.shape[1]
    n_cb = -(-Bt.shape[0] // bw)
    pad = n_cb * bw - Bt.shape[0]
    blocks = (F.pad(Bt, (0, 0, 0, pad)) if pad else Bt).reshape(n_cb, bw, k)
    cblock = (step_cblock.repeat_interleave(fat_group) if fat_group > 1
              else step_cblock)
    a = A_panels.index_select(0, tile_panel)
    b = blocks.index_select(0, cblock)
    return torch.bmm(a, b.transpose(1, 2)).to(out_dtype)


def bsr_dense(A_panels: torch.Tensor, Bt: torch.Tensor,
              tile_panel: torch.Tensor, step_cblock: torch.Tensor, *,
              fat_group: int, block_width: int,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense BSR tier: (T, ph, bw) tiles, tile t from panel
    ``tile_panel[t]`` and column block ``step_cblock[t // fat_group]`` of
    ``Bt`` (N, K). Kernel on CUDA tensors, plain version on CPU tensors."""
    dev = _check_operands("bsr_dense", A_panels, Bt,
                          (("tile_panel", tile_panel),
                           ("step_cblock", step_cblock)), out_dtype)
    T, G = tile_panel.shape[0], fat_group
    _check(G >= 1 and T % G == 0 and step_cblock.shape == (T // G,),
           f"bsr_dense: step_cblock must hold T/G = {T}/{G} block ids, got "
           f"{tuple(step_cblock.shape)}")
    if dev.type == "cpu":
        return bsr_dense_plain(A_panels, Bt, tile_panel, step_cblock,
                               fat_group=G, block_width=block_width,
                               out_dtype=out_dtype)
    ph, K = A_panels.shape[1], A_panels.shape[2]
    _check((ph, block_width) in GEOMETRIES,
           f"bsr_dense: no kernel for tile {ph}x{block_width}")
    ptrs = _launch_args(dev, (A_panels, Bt, tile_panel, step_cblock))
    out = torch.empty((T, ph, block_width), dtype=out_dtype, device=dev)
    if T == 0:
        return out
    from bsmr_sddmm_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.bsmr_bsr_dense(
            *ptrs, out.data_ptr(), T, G, ph, block_width, K, Bt.shape[0],
            int(out_dtype == torch.float16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on("bsr_dense", err)
    bsr_dense.launches += 1
    return out


bsr_dense.launches = 0


# ---------------------------------------------------------------------------
# Hot-column packed tier
# ---------------------------------------------------------------------------

def subpack_plain(A_panels: torch.Tensor, Bt2: torch.Tensor,
                  sp_panel: torch.Tensor, sp_sub: torch.Tensor, *,
                  subblock_width: int,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of :func:`subpack`: ``out[t] = A_panels[sp_panel[t]]
    @ concat_s(Bt2[sp_sub[t, s]*sw : +sw]).T``, rows of Bt2 at or past H
    reading as zero. (Tp, ph, S*sw)."""
    sw, k = subblock_width, Bt2.shape[1]
    Tp, S = sp_sub.shape
    n_sb = -(-Bt2.shape[0] // sw)
    pad = n_sb * sw - Bt2.shape[0]
    subs = (F.pad(Bt2, (0, 0, 0, pad)) if pad else Bt2).reshape(n_sb, sw, k)
    a = A_panels.index_select(0, sp_panel)
    b = subs.index_select(0, sp_sub.reshape(-1)).reshape(Tp, S * sw, k)
    return torch.bmm(a, b.transpose(1, 2)).to(out_dtype)


def subpack(A_panels: torch.Tensor, Bt2: torch.Tensor,
            sp_panel: torch.Tensor, sp_sub: torch.Tensor, *,
            subblock_width: int,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Hot-column packed tier: (Tp, ph, S*sw) tiles, tile t from panel
    ``sp_panel[t]`` and the S sub-blocks ``sp_sub[t]`` of ``Bt2`` (H, K).
    Kernel on CUDA tensors, plain version on CPU tensors."""
    dev = _check_operands("subpack", A_panels, Bt2,
                          (("sp_panel", sp_panel), ("sp_sub", sp_sub)),
                          out_dtype)
    sw = subblock_width
    _check(sp_sub.dim() == 2 and sp_sub.shape[0] == sp_panel.shape[0]
           and sw > 0, f"subpack: sp_sub must be (Tp, S), got "
           f"{tuple(sp_sub.shape)} for Tp={sp_panel.shape[0]}")
    if dev.type == "cpu":
        return subpack_plain(A_panels, Bt2, sp_panel, sp_sub,
                             subblock_width=sw, out_dtype=out_dtype)
    Tp, S = sp_sub.shape
    ph, K, bw = A_panels.shape[1], A_panels.shape[2], S * sw
    _check((ph, bw) in GEOMETRIES,
           f"subpack: no kernel for tile {ph}x{bw}")
    ptrs = _launch_args(dev, (A_panels, Bt2, sp_panel, sp_sub))
    out = torch.empty((Tp, ph, bw), dtype=out_dtype, device=dev)
    if Tp == 0:
        return out
    from bsmr_sddmm_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.bsmr_subpack(
            *ptrs, out.data_ptr(), Tp, S, sw, ph, bw, K, Bt2.shape[0],
            int(out_dtype == torch.float16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on("subpack", err)
    subpack.launches += 1
    return out


subpack.launches = 0
