"""Hand-written Hopper kernels of the SDDMM body's tile tiers, their
wrappers and their plain PyTorch versions.

``bsr_dense`` (csrc/bsr_dense.cu) replaces the JAX package's Pallas kernels
``make_bsr_fat_kernel`` (bsmr_sddmm_tpu/ops/pallas_dense.py:419-480, G > 1)
and ``make_bsr_dense_kernel`` (:144-201, G = 1): one kernel, where tile t
reads column block ``step_cblock[t // G]``; a G = 1 plan passes its
``tile_cblock`` as ``step_cblock``. ``subpack`` (csrc/subpack.cu) replaces
``make_subpack_kernel`` (:261-327) and the body's ``Bt[sp_colperm]`` gather
before it: the kernel reads the hot columns through ``sp_colperm`` itself.
``dense_tile`` and ``fused_gathered`` are two wrappers over one kernel
(csrc/gathered_tile.cu) whose tile t reads the bw rows ``Bt[cols[t, :]]``
by index: ``dense_tile`` replaces
``make_dense_tile_kernel`` (:204-252, the ``col_mode="reorder"`` dense
tier) and ``fused_gathered`` replaces ``make_fused_gathered_kernel``
(:330-416, the ``gathered_backend="fused"`` gathered tier). Each keeps its
own launch count, so a run shows which tier went through the kernel.

What bounds them on the card (:func:`tile_work` computes it): a (ph x bw) =
(32 x 128) tile at K = 128 is 2^20 multiply-adds, three times that in TF32
passes, for 16 KB of output; the operands are shared between tiles (each
referenced row counted once). On banded_mesh_32k's plan the dense tier's
bound is 0.059 ms at K = 128 (operations, bytes within 6%) and 0.048 ms at
K = 32 (bytes: the output store); the gathered tiles are bound by bytes
(PERF.md has the table and the measured times). The design, for sm_90a
(csrc/tile_mma.cuh): tensor cores through ``mma.sync.m16n8k8`` with three
TF32 passes (each value split ``hi = cvt.rna.tf32(x)``, ``lo =
cvt.rna.tf32(x - hi)``; ``a_lo*b_hi + a_hi*b_lo + a_hi*b_hi`` in fp32
accumulators, the card's form of the JAX kernel's bf16x3 split), which
keeps ~fp32 accuracy: :func:`tf32_split` and :func:`three_pass_matmul` are
its plain-torch statement, used by the tests. Operands reach shared memory
by ``cp.async`` (16 bytes a thread, zero fill for missing rows and the K
tail; 4 bytes a thread where K % 4 != 0) into padded K-major rows whose
fragment reads (``ldmatrix``) have no bank conflicts; a warp owns 32 rows
by a quarter of the tile's columns, so a tile takes 4 warps. ``bsr_dense``
keeps a fat step's column block resident in shared memory, split once into
hi and lo, in the swizzled layout that warpgroup MMAs (``wgmma``) read
directly (csrc/tile_wgmma.cuh); persistent thread blocks each walk a
contiguous share of the (step, 64 rows) units, the A panels streaming past
the block through a ``cp.async`` ring; at G = 1, and where the block does
not fit, it walks K in chunks of 32 through a 2-stage ring with both
operands split on the fly, as the gathered tiles and the packed tiles
always do. The epilogue writes 16-byte streaming stores. PERF.md has every
kernel's time on an H100 beside its bound. Left for later: producer warps
and TMA loads for ``bsr_dense``, and ``wgmma`` for the streaming route.

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
#: instantiated for (BSMR_MMA_FOR_EACH_GEOMETRY in csrc/tile_mma.cuh).
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
# Work and bound of a tile kernel; the three-pass TF32 product
# ---------------------------------------------------------------------------

#: NVIDIA H100 SXM data-sheet peaks: device memory bytes/s and dense TF32
#: tensor-core flop/s.
H100_BYTES_PER_S = 3.35e12
H100_TF32_FLOPS = 495e12
#: TF32 passes per product (hi*hi, lo*hi, hi*lo)
TF32_PASSES = 3


def tile_work(T: int, ph: int, bw: int, K: int, out_dtype: torch.dtype,
              a_rows: int, b_rows: int, index_bytes: int = 0) -> dict:
    """Work of one launch of a tile kernel and the least time an H100 could
    take for it.

    ``T`` tiles of (ph x bw) at depth K: ``flops = 2*T*ph*bw*K``. Bytes:
    every operand row the launch references counted once (``a_rows`` rows
    of A and ``b_rows`` rows of B, K floats each), the index arrays
    (``index_bytes``) once, the output once in ``out_dtype``. ``bound_ms``
    is the larger of bytes over the memory rate and the three TF32 passes'
    operations over the tensor-core rate; ``bound_by`` names that side."""
    flops = 2 * T * ph * bw * K
    out_bytes = T * ph * bw * torch.empty((), dtype=out_dtype).element_size()
    nbytes = out_bytes + 4 * K * (a_rows + b_rows) + index_bytes
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = TF32_PASSES * flops / H100_TF32_FLOPS * 1e3
    return dict(flops=flops, bytes=nbytes, out_bytes=out_bytes,
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def tf32_split(x: torch.Tensor):
    """``(hi, lo)`` of a float32 tensor as the kernels split it: ``hi`` is
    ``x`` rounded to TF32 (10 explicit mantissa bits; the 13 dropped bits
    round to nearest, ties away from zero, as ``cvt.rna.tf32.f32``), by
    integer arithmetic on the bit pattern; ``lo`` is ``x - hi`` rounded the
    same way. Both are float32 tensors holding TF32 values."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def three_pass_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a @ b_t.T`` (batched over leading dims) as the tensor-core kernels
    compute it: ``a_lo*b_hi + a_hi*b_lo + a_hi*b_hi`` on TF32-split
    operands with fp32 sums (each pass is exact in fp32 products, as the
    MMA's are). Plain torch, for tests."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b_t)
    bh, bl = b_hi.transpose(-1, -2), b_lo.transpose(-1, -2)
    return a_lo @ bh + a_hi @ bl + a_hi @ bh


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

def subpack_plain(A_panels: torch.Tensor, Bt: torch.Tensor,
                  sp_colperm: torch.Tensor, sp_panel: torch.Tensor,
                  sp_sub: torch.Tensor, *, subblock_width: int,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of :func:`subpack`: ``out[t] = A_panels[sp_panel[t]]
    @ concat_s(Bt2[sp_sub[t, s]*sw : +sw]).T`` with ``Bt2 =
    Bt[sp_colperm]`` (H, K), rows of Bt2 at or past H reading as zero
    (through one block of zeros appended to Bt2). (Tp, ph, S*sw)."""
    sw, k = subblock_width, Bt.shape[1]
    Tp, S = sp_sub.shape
    Bt2 = Bt.index_select(0, sp_colperm)
    n_sb = -(-Bt2.shape[0] // sw)
    pad = (n_sb + 1) * sw - Bt2.shape[0]
    subs = F.pad(Bt2, (0, 0, 0, pad)).reshape(n_sb + 1, sw, k)
    ids = sp_sub.reshape(-1).long()
    ids = torch.where((ids >= 0) & (ids < n_sb), ids, n_sb)
    a = A_panels.index_select(0, sp_panel)
    b = subs.index_select(0, ids).reshape(Tp, S * sw, k)
    return torch.bmm(a, b.transpose(1, 2)).to(out_dtype)


def subpack(A_panels: torch.Tensor, Bt: torch.Tensor,
            sp_colperm: torch.Tensor, sp_panel: torch.Tensor,
            sp_sub: torch.Tensor, *, subblock_width: int,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Hot-column packed tier: (Tp, ph, S*sw) tiles, tile t from panel
    ``sp_panel[t]`` and the S sub-blocks ``sp_sub[t]`` of the hot columns:
    sub-block j is the sw rows ``Bt[sp_colperm[j*sw : (j+1)*sw]]`` of ``Bt``
    (N, K), read by index inside the kernel (``Bt[sp_colperm]`` is never
    materialised). Kernel on CUDA tensors, plain version on CPU tensors."""
    dev = _check_operands("subpack", A_panels, Bt,
                          (("sp_colperm", sp_colperm), ("sp_panel", sp_panel),
                           ("sp_sub", sp_sub)), out_dtype)
    sw = subblock_width
    _check(sp_sub.dim() == 2 and sp_sub.shape[0] == sp_panel.shape[0]
           and sw > 0, f"subpack: sp_sub must be (Tp, S), got "
           f"{tuple(sp_sub.shape)} for Tp={sp_panel.shape[0]}")
    _check(sp_colperm.dim() == 1, f"subpack: sp_colperm must be (H,), got "
           f"{tuple(sp_colperm.shape)}")
    if dev.type == "cpu":
        return subpack_plain(A_panels, Bt, sp_colperm, sp_panel, sp_sub,
                             subblock_width=sw, out_dtype=out_dtype)
    Tp, S = sp_sub.shape
    ph, K, bw = A_panels.shape[1], A_panels.shape[2], S * sw
    _check((ph, bw) in GEOMETRIES,
           f"subpack: no kernel for tile {ph}x{bw}")
    ptrs = _launch_args(dev, (A_panels, Bt, sp_colperm, sp_panel, sp_sub))
    out = torch.empty((Tp, ph, bw), dtype=out_dtype, device=dev)
    if Tp == 0:
        return out
    from bsmr_sddmm_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.bsmr_subpack(
            *ptrs, out.data_ptr(), Tp, S, sw, ph, bw, K,
            sp_colperm.shape[0], Bt.shape[0],
            int(out_dtype == torch.float16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on("subpack", err)
    subpack.launches += 1
    return out


subpack.launches = 0


# ---------------------------------------------------------------------------
# Gathered-column tiles: the reorder dense tier and the fused gathered tier
# ---------------------------------------------------------------------------

def gathered_tile_plain(A_panels: torch.Tensor, Bt: torch.Tensor,
                        panel: torch.Tensor, cols: torch.Tensor, *,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Plain version of the gathered-tile kernel: ``out[t] =
    A_panels[panel[t]] @ Bt[cols[t, :]].T``, ids outside [0, N) reading as
    zero (through one zero row appended to Bt). (T, ph, bw)."""
    T, bw = cols.shape
    N, k = Bt.shape
    ids = cols.reshape(-1).long()
    ids = torch.where((ids >= 0) & (ids < N), ids, N)
    b = F.pad(Bt, (0, 0, 0, 1)).index_select(0, ids).reshape(T, bw, k)
    a = A_panels.index_select(0, panel)
    return torch.bmm(a, b.transpose(1, 2)).to(out_dtype)


def _gathered_tile(wrapper, A_panels: torch.Tensor, Bt: torch.Tensor,
                   panel: torch.Tensor, cols: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Shared body of :func:`dense_tile` and :func:`fused_gathered`; a
    launch counts in ``wrapper.launches``."""
    name = wrapper.__name__
    dev = _check_operands(name, A_panels, Bt,
                          (("panel ids", panel), ("column ids", cols)),
                          out_dtype)
    _check(cols.dim() == 2 and panel.dim() == 1
           and cols.shape[0] == panel.shape[0],
           f"{name}: column ids must be (T, bw) for T = {panel.shape[0]} "
           f"panel ids, got {tuple(cols.shape)}")
    if dev.type == "cpu":
        return gathered_tile_plain(A_panels, Bt, panel, cols,
                                   out_dtype=out_dtype)
    T, bw = cols.shape
    ph, K = A_panels.shape[1], A_panels.shape[2]
    _check((ph, bw) in GEOMETRIES, f"{name}: no kernel for tile {ph}x{bw}")
    ptrs = _launch_args(dev, (A_panels, Bt, panel, cols))
    out = torch.empty((T, ph, bw), dtype=out_dtype, device=dev)
    if T == 0:
        return out
    from bsmr_sddmm_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.bsmr_gathered_tile(
            *ptrs, out.data_ptr(), T, ph, bw, K, Bt.shape[0],
            int(out_dtype == torch.float16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(name, err)
    wrapper.launches += 1
    return out


#: Plain versions of :func:`dense_tile` and :func:`fused_gathered`.
dense_tile_plain = fused_gathered_plain = gathered_tile_plain


def dense_tile(A_panels: torch.Tensor, Bt: torch.Tensor,
               tile_panel: torch.Tensor, tile_cols: torch.Tensor, *,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reorder-mode dense tier: (T, ph, bw) tiles, tile t from panel
    ``tile_panel[t]`` and the bw rows ``tile_cols[t]`` of ``Bt`` (N, K).
    Kernel on CUDA tensors, plain version on CPU tensors."""
    return _gathered_tile(dense_tile, A_panels, Bt, tile_panel, tile_cols,
                          out_dtype)


dense_tile.launches = 0


def fused_gathered(A_panels: torch.Tensor, Bt: torch.Tensor,
                   g_panel: torch.Tensor, g_cols: torch.Tensor, *,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused gathered tier: (Tg, ph, bw) tiles, tile t from panel
    ``g_panel[t]`` and the bw rows ``g_cols[t]`` of ``Bt`` (N, K), read
    inside the kernel. Kernel on CUDA tensors, plain version on CPU
    tensors."""
    return _gathered_tile(fused_gathered, A_panels, Bt, g_panel, g_cols,
                          out_dtype)


fused_gathered.launches = 0
