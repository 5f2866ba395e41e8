// Hot-column packed tier of the SDDMM body: one thread block per packed
// tile, whose B operand is S = BW/sw sub-blocks of sw hot columns each. The
// hot columns are listed by sp_colperm (H ids into Bt); sub-block j is the
// ids sp_colperm[j*sw : (j+1)*sw]:
//
//   out[t] = A_panels[sp_panel[t]] . concat_s(Bt2[sp_sub[t,s]*sw : +sw])^T,
//   Bt2 = Bt[sp_colperm].
//
// Replaces the JAX package's Pallas kernel make_subpack_kernel in
// bsmr_sddmm_tpu/ops/pallas_dense.py. That kernel is fed Bt2 itself, gathered
// once a call, because its TPU streams a contiguous (sw x K) slice several
// times cheaper than sw separate rows. This card has no such cliff, so Bt2
// is never materialised: the block resolves its BW row pointers once,
//
//   rows[c] = Bt + sp_colperm[sp_sub[t, c / sw] * sw + c % sw] * K,
//
// (null, a row of zeros, at or past H or for an id outside [0, N), which
// takes the place of the JAX wrapper's pad of Bt2) and from there it is a
// gathered tile (tile_mma.cuh: tile_mma_stream): the A panel and the BW rows
// stream in K-chunks of 32 through a 2-stage cp.async ring, 128 contiguous
// bytes a row and chunk, under tensor-core MMAs in three TF32 passes, four
// blocks to an SM, 16-byte streaming stores.
//
// What bounds it: bytes. At (PH, BW, K) = (32, 128, 128) a tile writes 16 KB
// for 3 * 2^20 TF32 operations, and every referenced row of Bt and panel of
// A counts once, the tiles re-reading them from L1/L2 (a hot column's row
// serves about four tiles on banded_mesh_32k). Measured on an H100
// (PERF.md, ops/subpack_phases.py): the kernel runs at 2.6x that bound at
// K = 128; with the copies left out the MMA loop (mma.sync, both operands
// split on the fly) takes 70% of the whole time, with the MMAs left out the
// copies and stores 56%: the two overlap only across an SM's four blocks.
//
// Pad tiles (panel 0, sub-block 0) and pad slots (the tile's first
// sub-block) are computed like real ones. Plain C interface for ctypes;
// returns the first CUDA error of the launch.
#include "tile_mma.cuh"

namespace {

using namespace bsmr;

template <int PH, int BW, typename OutT>
__global__ void __launch_bounds__(Tiling<PH, BW>::THREADS)
    subpack_kernel(const float* __restrict__ A_panels,
                   const float* __restrict__ Bt,
                   const int* __restrict__ sp_colperm,
                   const int* __restrict__ sp_panel,
                   const int* __restrict__ sp_sub, OutT* __restrict__ out,
                   int S, int sw, int K, int H, int N, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.x;
  const float* a = A_panels + static_cast<size_t>(sp_panel[t]) * PH * K;
  const int* sub = sp_sub + static_cast<size_t>(t) * S;
  auto b_row = [=](int c) -> const float* {
    const int s = c / sw;
    const long long h = static_cast<long long>(sub[s]) * sw + (c - s * sw);
    if (h < 0 || h >= H) return nullptr;
    const int n = sp_colperm[h];
    return (n >= 0 && n < N) ? Bt + static_cast<size_t>(n) * K : nullptr;
  };
  tile_mma_stream<PH, BW>(a, b_row, K, vec,
                          out + static_cast<size_t>(t) * PH * BW, smem,
                          A_panels);
}

template <int PH, int BW, typename OutT>
int launch(const float* a, const float* b, const int* cp, const int* p,
           const int* sb, void* out, int Tp, int S, int sw, int K, int H,
           int N, bool vec, cudaStream_t s) {
  auto kern = subpack_kernel<PH, BW, OutT>;
  const int bytes = stream_smem_bytes<PH, BW>(K);
  static SmemLimit limit;
  int device = 0;
  const cudaError_t err = limit.raise(kern, bytes, &device);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<Tp, Tiling<PH, BW>::THREADS, bytes, s>>>(
      a, b, cp, p, sb, static_cast<OutT*>(out), S, sw, K, H, N, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bsmr_subpack(const void* A_panels, const void* Bt,
                            const void* sp_colperm, const void* sp_panel,
                            const void* sp_sub, void* out, int Tp, int S,
                            int sw, int ph, int bw, int K, int H, int N,
                            int out_f16, void* stream) {
  if (Tp <= 0 || K <= 0 || S <= 0 || sw <= 0 || S * sw != bw)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A_panels);
  const float* b = static_cast<const float*>(Bt);
  const int* cp = static_cast<const int*>(sp_colperm);
  const int* p = static_cast<const int*>(sp_panel);
  const int* sb = static_cast<const int*>(sp_sub);
  const bool vec = vector_path(a, b, K);
#define BSMR_LAUNCH(PH, BW)                                                  \
  if (ph == PH && bw == BW)                                                  \
    return out_f16 ? launch<PH, BW, __half>(a, b, cp, p, sb, out, Tp, S, sw, \
                                            K, H, N, vec, s)                 \
                   : launch<PH, BW, float>(a, b, cp, p, sb, out, Tp, S, sw,  \
                                           K, H, N, vec, s);
  BSMR_MMA_FOR_EACH_GEOMETRY(BSMR_LAUNCH)
#undef BSMR_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
