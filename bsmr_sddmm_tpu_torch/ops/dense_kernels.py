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
(:330-416, the ``gathered_backend="fused"`` gathered tier). ``csr_emit``
(csrc/csr_emit.cu) replaces no Pallas kernel: it gathers the body's CSR
values straight from the four tier arrays, where the JAX body concatenates
them and takes along ``rphm_to_csr``; it moves bits, bound by bytes.
``residual`` (csrc/residual.cu) replaces no Pallas kernel either: the JAX
body leaves the per-nonzero residual to XLA (a row gather of each operand, a
multiply and a sum); the kernel reads each nonzero's two rows straight from
the operands and writes one fp32 dot product, with no (E, K) copy, bound by
bytes. Each keeps its own launch count, so a run shows which tier went
through the kernel.

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
its plain-torch statement, used by the tests. Every wrapper takes
``passes=1`` too (``SddmmConfig.matmul_precision="default"``): one pass,
``a_hi*b_hi``, the CUDA original's own TF32 arithmetic, a third of the
MMAs; its plain version is an fp32 product of the ``hi`` operands, which
the MMA's exact products and fp32 sums match up to the order of summation.
Operands reach shared memory
by ``cp.async`` (16 bytes a thread, zero fill for missing rows and the K
tail; 4 bytes a thread where K % 4 != 0) into padded K-major rows whose
fragment reads (``ldmatrix``) have no bank conflicts; a warp owns 32 rows
by a quarter of the tile's columns, so a tile takes 4 warps. ``bsr_dense``
keeps a fat step's column block resident in shared memory, split once into
hi and lo, in the swizzled layout that warpgroup MMAs (``wgmma``) read
directly (csrc/tile_wgmma.cuh); persistent thread blocks each walk a
contiguous share of the (step, 64 rows) units, the A panels streaming past
the block through a ``cp.async`` ring; where the block does not fit (K
above 128 at bw 128, above 64 at bw 256) it keeps one 64-column slice of it
instead (K up to 352), over (step, slice, 64 rows) units; at G = 1, and
beyond the slice's reach, it walks K in chunks of 32 through a 2-stage
ring with both operands split on the fly, as the gathered tiles and the
packed tiles always do (:func:`bsr_route` names the route). The epilogue
writes 16-byte streaming stores. PERF.md has every kernel's time on an H100
beside its bound. Left for later: producer warps and TMA loads for
``bsr_dense``.

Each wrapper checks its inputs and then dispatches on the device of its
tensors: CPU tensors go to the plain version, CUDA tensors launch the
kernel on the current stream (no synchronisation) or raise. It counts its
launches in ``<wrapper>.launches``, a plain int that only a kernel launch
increments (``bsr_dense`` also by route, in ``bsr_dense.routes``);
:data:`WRAPPERS` names every counting wrapper, so the
counters' readers (``utils.profiling.counters``, ``parallel.worker``,
``chip_smoke.py``) need no list of their own. The plain versions'
``torch.bmm`` runs in full fp32 whatever the caller set for TF32
(:func:`tf32_matmuls`).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

#: Tile geometries (panel_height, block_width) the CUDA kernels are
#: instantiated for (BSMR_MMA_FOR_EACH_GEOMETRY in csrc/tile_mma.cuh).
GEOMETRIES = frozenset((ph, bw) for ph in (8, 16, 32, 64) for bw in (128, 256))
_OUT_DTYPES = (torch.float32, torch.float16)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_operands(name, A_panels, B, index_pairs, out_dtype, passes):
    _check(passes in (1, 3), f"{name}: passes must be 1 or 3, got {passes}")
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


def tile_work(T: int, ph: int, bw: int, K: int, out_dtype: torch.dtype,
              a_rows: int, b_rows: int, index_bytes: int = 0,
              passes: int = 3) -> dict:
    """Work of one launch of a tile kernel and the least time an H100 could
    take for it.

    ``T`` tiles of (ph x bw) at depth K: ``flops = 2*T*ph*bw*K``. Bytes:
    every operand row the launch references counted once (``a_rows`` rows
    of A and ``b_rows`` rows of B, K floats each), the index arrays
    (``index_bytes``) once, the output once in ``out_dtype``. ``bound_ms``
    is the larger of bytes over the memory rate and the operations of
    ``passes`` TF32 passes (3: hi*hi, lo*hi, hi*lo; 1: hi*hi) over the
    tensor-core rate; ``bound_by`` names that side."""
    flops = 2 * T * ph * bw * K
    out_bytes = T * ph * bw * torch.empty((), dtype=out_dtype).element_size()
    nbytes = out_bytes + 4 * K * (a_rows + b_rows) + index_bytes
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = passes * flops / H100_TF32_FLOPS * 1e3
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


@contextlib.contextmanager
def tf32_matmuls(allow: bool):
    """torch's CUDA fp32 matmuls inside the block in one TF32 pass
    (``allow``) or in full fp32 (not), whatever the caller set in
    ``torch.backends.cuda.matmul.allow_tf32``; the caller's setting is put
    back after. CPU matmuls are fp32 either way."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _tiles_product(a: torch.Tensor, b: torch.Tensor,
                   passes: int) -> torch.Tensor:
    """``bmm(a, b^T)`` as the kernels compute it at ``passes``: in full fp32
    at 3 (the split's result to ~2^-22 per product), on the ``hi`` halves
    of both operands at 1 (each product of two TF32 values is exact in fp32,
    as in the MMA); TF32 off either way."""
    if passes == 1:
        a, b = tf32_split(a)[0], tf32_split(b)[0]
    with tf32_matmuls(False):
        return torch.bmm(a, b.transpose(1, 2))


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

#: the constants of csrc/ that :func:`bsr_route` reads, under their names
#: there (tests hold them to the sources)
ROUTE_CONSTANTS = dict(kMaxSmem=232448, kSlabK=32, kPadK=4, kUnitRows=64,
                       kSliceCols=64, kSliceChunk=32, kSliceUnits=2,
                       kSliceStages=6, kChunkK=32, kStreamStages=2)
#: :func:`bsr_dense`'s routes, in the order of csrc/bsr_dense.cu's Route
BSR_ROUTES = ("resident", "sliced", "stream")


def bsr_route(fat_group: int, panel_height: int, block_width: int,
              k: int) -> tuple:
    """``(route, smem_bytes)``: the route csrc/bsr_dense.cu's launch takes
    for a fat group G, tile (ph x bw) and depth K, and the dynamic shared
    memory it asks for. ``"resident"`` where G >= 2 and the whole column
    block (hi and lo halves, K rounded up to 32) fits beside a ring of 2
    A units (3 where they fit); ``"sliced"`` where G >= 2 and a 64-column
    slice fits beside a ring of 2 stages of 32 K-columns of two units (as
    many stages as fit, up to 6; K up to 352 at either width); ``"stream"``
    otherwise. The formulas are the launch's (``resident_bytes``,
    ``sliced_bytes``, ``stream_smem_bytes``)."""
    c = ROUTE_CONSTANTS
    k8, k32 = -(-k // 8) * 8, -(-k // c["kSlabK"]) * c["kSlabK"]

    def resident(stages):
        return 1024 + 4 * (2 * block_width * k32
                           + stages * c["kUnitRows"] * (k8 + c["kPadK"]))

    def sliced(stages):
        return 1024 + 4 * (2 * c["kSliceCols"] * k32
                           + stages * c["kSliceUnits"] * c["kUnitRows"]
                           * (c["kSliceChunk"] + c["kPadK"]))

    fits = c["kMaxSmem"]
    if fat_group >= 2 and resident(2) <= fits:
        return "resident", resident(3 if resident(3) <= fits else 2)
    if fat_group >= 2 and sliced(2) <= fits:
        stages = max(s for s in range(2, c["kSliceStages"] + 1)
                     if s == 2 or sliced(s) <= fits)
        return "sliced", sliced(stages)
    rows = max(panel_height, 16) + block_width
    chunks = min(-(-k // c["kChunkK"]), c["kStreamStages"])
    return "stream", 4 * chunks * rows * (c["kChunkK"] + c["kPadK"])


def bsr_dense_plain(A_panels: torch.Tensor, Bt: torch.Tensor,
                    tile_panel: torch.Tensor, step_cblock: torch.Tensor, *,
                    fat_group: int, block_width: int,
                    out_dtype: torch.dtype = torch.float32,
                    passes: int = 3) -> torch.Tensor:
    """Plain version of :func:`bsr_dense`: ``out[t] = A_panels[tile_panel[t]]
    @ Bt[cb*bw : (cb+1)*bw].T`` with ``cb = step_cblock[t // fat_group]``,
    rows of Bt at or past N reading as zero, at ``passes`` TF32 passes
    (:func:`_tiles_product`). (T, ph, bw)."""
    bw, k = block_width, Bt.shape[1]
    n_cb = -(-Bt.shape[0] // bw)
    pad = n_cb * bw - Bt.shape[0]
    blocks = (F.pad(Bt, (0, 0, 0, pad)) if pad else Bt).reshape(n_cb, bw, k)
    cblock = (step_cblock.repeat_interleave(fat_group) if fat_group > 1
              else step_cblock)
    a = A_panels.index_select(0, tile_panel)
    b = blocks.index_select(0, cblock)
    return _tiles_product(a, b, passes).to(out_dtype)


def bsr_dense(A_panels: torch.Tensor, Bt: torch.Tensor,
              tile_panel: torch.Tensor, step_cblock: torch.Tensor, *,
              fat_group: int, block_width: int,
              out_dtype: torch.dtype = torch.float32,
              passes: int = 3) -> torch.Tensor:
    """Dense BSR tier: (T, ph, bw) tiles, tile t from panel
    ``tile_panel[t]`` and column block ``step_cblock[t // fat_group]`` of
    ``Bt`` (N, K), in ``passes`` (3 or 1) TF32 passes. Kernel on CUDA
    tensors, plain version on CPU tensors."""
    dev = _check_operands("bsr_dense", A_panels, Bt,
                          (("tile_panel", tile_panel),
                           ("step_cblock", step_cblock)), out_dtype, passes)
    T, G = tile_panel.shape[0], fat_group
    _check(G >= 1 and T % G == 0 and step_cblock.shape == (T // G,),
           f"bsr_dense: step_cblock must hold T/G = {T}/{G} block ids, got "
           f"{tuple(step_cblock.shape)}")
    if dev.type == "cpu":
        return bsr_dense_plain(A_panels, Bt, tile_panel, step_cblock,
                               fat_group=G, block_width=block_width,
                               out_dtype=out_dtype, passes=passes)
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
            int(out_dtype == torch.float16), passes,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on("bsr_dense", err)
    bsr_dense.launches += 1
    bsr_dense.routes[bsr_route(G, ph, block_width, K)[0]] += 1
    return out


bsr_dense.launches = 0
#: launches by route (:func:`bsr_route`), read as ``bsr_dense.route.<r>``
bsr_dense.routes = dict.fromkeys(BSR_ROUTES, 0)


# ---------------------------------------------------------------------------
# Hot-column packed tier
# ---------------------------------------------------------------------------

def subpack_plain(A_panels: torch.Tensor, Bt: torch.Tensor,
                  sp_colperm: torch.Tensor, sp_panel: torch.Tensor,
                  sp_sub: torch.Tensor, *, subblock_width: int,
                  out_dtype: torch.dtype = torch.float32,
                  passes: int = 3) -> torch.Tensor:
    """Plain version of :func:`subpack`: ``out[t] = A_panels[sp_panel[t]]
    @ concat_s(Bt2[sp_sub[t, s]*sw : +sw]).T`` with ``Bt2 =
    Bt[sp_colperm]`` (H, K), rows of Bt2 at or past H reading as zero
    (through one block of zeros appended to Bt2), at ``passes`` TF32
    passes. (Tp, ph, S*sw)."""
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
    return _tiles_product(a, b, passes).to(out_dtype)


def subpack(A_panels: torch.Tensor, Bt: torch.Tensor,
            sp_colperm: torch.Tensor, sp_panel: torch.Tensor,
            sp_sub: torch.Tensor, *, subblock_width: int,
            out_dtype: torch.dtype = torch.float32,
            passes: int = 3) -> torch.Tensor:
    """Hot-column packed tier: (Tp, ph, S*sw) tiles, tile t from panel
    ``sp_panel[t]`` and the S sub-blocks ``sp_sub[t]`` of the hot columns:
    sub-block j is the sw rows ``Bt[sp_colperm[j*sw : (j+1)*sw]]`` of ``Bt``
    (N, K), read by index inside the kernel (``Bt[sp_colperm]`` is never
    materialised), in ``passes`` (3 or 1) TF32 passes. Kernel on CUDA
    tensors, plain version on CPU tensors."""
    dev = _check_operands("subpack", A_panels, Bt,
                          (("sp_colperm", sp_colperm), ("sp_panel", sp_panel),
                           ("sp_sub", sp_sub)), out_dtype, passes)
    sw = subblock_width
    _check(sp_sub.dim() == 2 and sp_sub.shape[0] == sp_panel.shape[0]
           and sw > 0, f"subpack: sp_sub must be (Tp, S), got "
           f"{tuple(sp_sub.shape)} for Tp={sp_panel.shape[0]}")
    _check(sp_colperm.dim() == 1, f"subpack: sp_colperm must be (H,), got "
           f"{tuple(sp_colperm.shape)}")
    if dev.type == "cpu":
        return subpack_plain(A_panels, Bt, sp_colperm, sp_panel, sp_sub,
                             subblock_width=sw, out_dtype=out_dtype,
                             passes=passes)
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
            int(out_dtype == torch.float16), passes,
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
                        out_dtype: torch.dtype = torch.float32,
                        passes: int = 3) -> torch.Tensor:
    """Plain version of the gathered-tile kernel: ``out[t] =
    A_panels[panel[t]] @ Bt[cols[t, :]].T``, ids outside [0, N) reading as
    zero (through one zero row appended to Bt), at ``passes`` TF32 passes.
    (T, ph, bw)."""
    T, bw = cols.shape
    N, k = Bt.shape
    ids = cols.reshape(-1).long()
    ids = torch.where((ids >= 0) & (ids < N), ids, N)
    b = F.pad(Bt, (0, 0, 0, 1)).index_select(0, ids).reshape(T, bw, k)
    a = A_panels.index_select(0, panel)
    return _tiles_product(a, b, passes).to(out_dtype)


def _gathered_tile(wrapper, A_panels: torch.Tensor, Bt: torch.Tensor,
                   panel: torch.Tensor, cols: torch.Tensor,
                   out_dtype: torch.dtype, passes: int) -> torch.Tensor:
    """Shared body of :func:`dense_tile` and :func:`fused_gathered`; a
    launch counts in ``wrapper.launches``."""
    name = wrapper.__name__
    dev = _check_operands(name, A_panels, Bt,
                          (("panel ids", panel), ("column ids", cols)),
                          out_dtype, passes)
    _check(cols.dim() == 2 and panel.dim() == 1
           and cols.shape[0] == panel.shape[0],
           f"{name}: column ids must be (T, bw) for T = {panel.shape[0]} "
           f"panel ids, got {tuple(cols.shape)}")
    if dev.type == "cpu":
        return gathered_tile_plain(A_panels, Bt, panel, cols,
                                   out_dtype=out_dtype, passes=passes)
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
            int(out_dtype == torch.float16), passes,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(name, err)
    wrapper.launches += 1
    return out


#: Plain versions of :func:`dense_tile` and :func:`fused_gathered`.
dense_tile_plain = fused_gathered_plain = gathered_tile_plain


def dense_tile(A_panels: torch.Tensor, Bt: torch.Tensor,
               tile_panel: torch.Tensor, tile_cols: torch.Tensor, *,
               out_dtype: torch.dtype = torch.float32,
               passes: int = 3) -> torch.Tensor:
    """Reorder-mode dense tier: (T, ph, bw) tiles, tile t from panel
    ``tile_panel[t]`` and the bw rows ``tile_cols[t]`` of ``Bt`` (N, K), in
    ``passes`` (3 or 1) TF32 passes. Kernel on CUDA tensors, plain version
    on CPU tensors."""
    return _gathered_tile(dense_tile, A_panels, Bt, tile_panel, tile_cols,
                          out_dtype, passes)


dense_tile.launches = 0


def fused_gathered(A_panels: torch.Tensor, Bt: torch.Tensor,
                   g_panel: torch.Tensor, g_cols: torch.Tensor, *,
                   out_dtype: torch.dtype = torch.float32,
                   passes: int = 3) -> torch.Tensor:
    """Fused gathered tier: (Tg, ph, bw) tiles, tile t from panel
    ``g_panel[t]`` and the bw rows ``g_cols[t]`` of ``Bt`` (N, K), read
    inside the kernel, in ``passes`` (3 or 1) TF32 passes. Kernel on CUDA
    tensors, plain version on CPU tensors."""
    return _gathered_tile(fused_gathered, A_panels, Bt, g_panel, g_cols,
                          out_dtype, passes)


fused_gathered.launches = 0


# ---------------------------------------------------------------------------
# CSR emission
# ---------------------------------------------------------------------------

def csr_emit_plain(tiers, rphm_to_csr: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`csr_emit`: every padded slot of the tiers,
    flattened and joined in order, then gathered along ``rphm_to_csr``."""
    return torch.cat([t.reshape(-1) for t in tiers]).index_select(
        0, rphm_to_csr)


def csr_emit(tiers, rphm_to_csr: torch.Tensor) -> torch.Tensor:
    """The body's (nnz,) values in CSR order: ``out[i]`` is slot
    ``rphm_to_csr[i]`` of the four tiers ``(dense, packed, gathered,
    residual)`` joined in that order, each read straight from its tier
    (csrc/csr_emit.cu), so the joined slots are never materialised. The
    tiers share one dtype of 4 or 2 bytes, copied bit for bit; a tier may
    be empty. Kernel on CUDA tensors, plain version on CPU tensors."""
    _check(len(tiers) == 4, f"csr_emit: needs the four tiers, got "
           f"{len(tiers)}")
    dtype, dev = tiers[0].dtype, rphm_to_csr.device
    _check(rphm_to_csr.dtype == torch.int32 and rphm_to_csr.dim() == 1,
           "csr_emit: rphm_to_csr must be (nnz,) int32")
    for t in tiers:
        _check(t.dtype == dtype, f"csr_emit: the tiers must share one "
               f"dtype, got {[t.dtype for t in tiers]}")
        _check(t.device == dev,
               f"csr_emit: all tensors must be on {dev}, got {t.device}")
    _check(tiers[0].element_size() in (2, 4),
           f"csr_emit: values must take 4 or 2 bytes, got {dtype}")
    counts = [t.numel() for t in tiers]
    _check(sum(counts) < 2 ** 31, f"csr_emit: {sum(counts)} slots do not "
           f"fit the int32 offsets of rphm_to_csr")
    if dev.type == "cpu":
        return csr_emit_plain(tiers, rphm_to_csr)
    ptrs = _launch_args(dev, (*tiers, rphm_to_csr))
    nnz = rphm_to_csr.shape[0]
    out = torch.empty(nnz, dtype=dtype, device=dev)
    if nnz == 0:
        return out
    from bsmr_sddmm_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.bsmr_csr_emit(
            *ptrs[:4], *counts, ptrs[4], out.data_ptr(), nnz,
            tiers[0].element_size(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on("csr_emit", err)
    csr_emit.launches += 1
    return out


csr_emit.launches = 0


def emit_work(tiers, rphm_to_csr: torch.Tensor) -> dict:
    """Bytes of one :func:`csr_emit` launch and the least time an H100
    could take to move them: per nonzero, 4 bytes of index read and one
    value written; and every distinct 32-byte sector of the tiers that
    holds a value read, counted once (neighbouring values of a CSR row
    mostly share one), at the tensors' own addresses. ``bound_ms`` is those
    bytes over the memory rate."""
    dev, elem = rphm_to_csr.device, tiers[0].element_size()
    counts = torch.tensor([t.numel() for t in tiers], dtype=torch.int64,
                          device=dev)
    ends = counts.cumsum(0)
    j = rphm_to_csr.long()
    tier = torch.searchsorted(ends, j, right=True)
    base = torch.tensor([t.data_ptr() for t in tiers], dtype=torch.int64,
                        device=dev)
    addr = base[tier] + (j - (ends - counts)[tier]) * elem
    sectors = int(torch.unique(addr // 32).numel())
    nbytes = rphm_to_csr.numel() * (4 + elem) + 32 * sectors
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return dict(bytes=nbytes, sectors=sectors, bytes_ms=bytes_ms,
                bound_ms=bytes_ms, bound_by="bytes")


# ---------------------------------------------------------------------------
# Residual tier
# ---------------------------------------------------------------------------

def residual_plain(A_perm: torch.Tensor, Bt: torch.Tensor,
                   res_arow: torch.Tensor, res_col: torch.Tensor, *,
                   out_dtype: torch.dtype = torch.float32,
                   chunk: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`residual`: a row gather of each operand, a
    multiply and a sum, ``chunk`` nonzeros at a time (all at once by
    default; the chunks change no value). (E,)."""
    E = res_arow.shape[0]
    step = max(E, 1) if chunk is None else chunk
    parts = [(A_perm.index_select(0, res_arow[s:s + step])
              * Bt.index_select(0, res_col[s:s + step])).sum(-1).to(out_dtype)
             for s in range(0, E, step)]
    if not parts:
        return A_perm.new_empty((0,), dtype=out_dtype)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def residual(A_perm: torch.Tensor, Bt: torch.Tensor, res_arow: torch.Tensor,
             res_col: torch.Tensor, *, out_dtype: torch.dtype = torch.float32,
             chunk: Optional[int] = None) -> torch.Tensor:
    """Residual tier: (E,) values ``out[e] = sum_k A_perm[res_arow[e], k] *
    Bt[res_col[e], k]`` of ``A_perm`` (rows, K) and ``Bt`` (N, K), fp32
    products and sums at every ``matmul_precision`` (no TF32 reaches them),
    each nonzero's two rows read inside the kernel (csrc/residual.cu), so
    no (E, K) copy exists. Kernel on CUDA tensors; plain version on CPU
    tensors, in row chunks of ``chunk`` nonzeros (the kernel needs none)."""
    _check(A_perm.dim() == 2 and Bt.dim() == 2
           and A_perm.shape[1] == Bt.shape[1],
           f"residual: A_perm must be (rows, K) and Bt (N, K), got "
           f"{tuple(A_perm.shape)} and {tuple(Bt.shape)}")
    _check(A_perm.dtype == torch.float32 and Bt.dtype == torch.float32,
           "residual: operands must be float32")
    _check(out_dtype in _OUT_DTYPES, f"residual: out_dtype must be float32 "
           f"or float16, got {out_dtype}")
    _check(res_arow.dim() == 1 and res_arow.shape == res_col.shape,
           f"residual: res_arow and res_col must be (E,), got "
           f"{tuple(res_arow.shape)} and {tuple(res_col.shape)}")
    dev = A_perm.device
    for label, t in (("res_arow", res_arow), ("res_col", res_col)):
        _check(t.dtype == torch.int32, f"residual: {label} must be int32")
    for t in (Bt, res_arow, res_col):
        _check(t.device == dev,
               f"residual: all tensors must be on {dev}, got {t.device}")
    if dev.type == "cpu":
        return residual_plain(A_perm, Bt, res_arow, res_col,
                              out_dtype=out_dtype, chunk=chunk)
    ptrs = _launch_args(dev, (A_perm, Bt, res_arow, res_col))
    E, K = res_arow.shape[0], A_perm.shape[1]
    out = torch.empty(E, dtype=out_dtype, device=dev)
    if E == 0:
        return out
    _check(K > 0, "residual: operands of depth 0")
    from bsmr_sddmm_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.bsmr_residual(
            *ptrs, out.data_ptr(), E, K, int(out_dtype == torch.float16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on("residual", err)
    residual.launches += 1
    return out


residual.launches = 0


def residual_work(A_perm: torch.Tensor, Bt: torch.Tensor,
                  res_arow: torch.Tensor, res_col: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> dict:
    """Bytes of one :func:`residual` launch and the least time an H100
    could take to move them: every distinct row of ``A_perm`` and of ``Bt``
    that a nonzero reads, K floats each, counted once; per nonzero 8 bytes
    of index read and one value written. ``bound_ms`` is those bytes over
    the memory rate (the 2·E·K fp32 operations take far less)."""
    E, K = res_arow.numel(), A_perm.shape[1]
    a_rows = int(torch.unique(res_arow).numel())
    b_rows = int(torch.unique(res_col).numel())
    elem = torch.empty((), dtype=out_dtype).element_size()
    nbytes = 4 * K * (a_rows + b_rows) + E * (8 + elem)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return dict(bytes=nbytes, a_rows=a_rows, b_rows=b_rows,
                bytes_ms=bytes_ms, bound_ms=bytes_ms, bound_by="bytes")


#: every wrapper that counts its launches in ``<wrapper>.launches``
WRAPPERS = (bsr_dense, subpack, dense_tile, fused_gathered, csr_emit,
            residual)
