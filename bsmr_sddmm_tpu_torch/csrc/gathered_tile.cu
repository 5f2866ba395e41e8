// Gathered-column tiles of the SDDMM body: one thread block per tile, whose
// B operand is BW rows of Bt picked by index,
//
//   out[t] = A_panels[panel[t]] . Bt[cols[t*BW : (t+1)*BW]]^T.
//
// Replaces two of the JAX package's Pallas kernels in
// bsmr_sddmm_tpu/ops/pallas_dense.py, which compute this same function:
// make_dense_tile_kernel (the col_mode="reorder" dense tier, fed B tiles
// that XLA gathered beforehand) and make_fused_gathered_kernel (the fused
// gathered tier, whose row DMAs are started by hand inside the kernel).
//
// What bounds it: bytes. At (PH, BW, K) = (32, 128, 128) a tile reads up to
// 64 KB of B rows that it shares with few other tiles, 16 KB of A and writes
// 16 KB, for 3 * 2^20 TF32 operations; no (T, BW, K) copy of gathered rows
// is ever materialised (the plain version's copy is 235 MB at T = 3584,
// K = 128). The design (tile_mma.cuh: tile_mma_stream): one thread block
// of 4 warps per tile (8 for 64-row panels); the tile's row pointers are
// resolved once into shared memory; the A panel and the BW rows then stream
// in K-chunks of 32 through a 2-stage cp.async ring, each row 128 contiguous
// bytes per chunk (16 bytes a thread, allocating in L1: neighbouring tiles
// share rows), the next chunk in flight under the tensor-core MMAs (three
// TF32 passes, or one) of this one; 45 KB of shared memory at (32, 128), so
// four blocks per SM overlap one tile's first loads and its 16-byte
// streaming stores with the others' MMAs. Any K is taken: where K % 4 != 0 the same
// pipeline copies 4 bytes a thread.
//
// Column ids need not be sorted or unique (pad tiles repeat one column). An
// id outside [0, N) reads as zero (cp.async zero fill), as rows past the end
// of B do in the other kernels. Plain C interface for ctypes; returns the
// first CUDA error of the launch.
#include "tile_mma.cuh"

namespace {

using namespace bsmr;

template <int PH, int BW, int PASSES, typename OutT>
__global__ void __launch_bounds__(Tiling<PH, BW>::THREADS)
    gathered_tile_kernel(const float* __restrict__ A_panels,
                         const float* __restrict__ Bt,
                         const int* __restrict__ panel,
                         const int* __restrict__ cols, OutT* __restrict__ out,
                         int K, int N, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.x;
  const float* a = A_panels + static_cast<size_t>(panel[t]) * PH * K;
  const int* tile_cols = cols + static_cast<size_t>(t) * BW;
  auto b_row = [=](int c) -> const float* {
    const int n = tile_cols[c];
    return (n >= 0 && n < N) ? Bt + static_cast<size_t>(n) * K : nullptr;
  };
  tile_mma_stream<PH, BW, PASSES>(a, b_row, K, vec,
                                  out + static_cast<size_t>(t) * PH * BW,
                                  smem, A_panels);
}

template <int PH, int BW, int PASSES, typename OutT>
int launch(const float* a, const float* b, const int* p, const int* c,
           void* out, int T, int K, int N, bool vec, cudaStream_t s) {
  auto kern = gathered_tile_kernel<PH, BW, PASSES, OutT>;
  const int bytes = stream_smem_bytes<PH, BW>(K);
  static SmemLimit limit;
  int device = 0;
  const cudaError_t err = limit.raise(kern, bytes, &device);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<T, Tiling<PH, BW>::THREADS, bytes, s>>>(
      a, b, p, c, static_cast<OutT*>(out), K, N, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// passes: 3 or 1 TF32 passes (tile_mma.cuh, numerics).
extern "C" int bsmr_gathered_tile(const void* A_panels, const void* Bt,
                                  const void* panel, const void* cols,
                                  void* out, int T, int ph, int bw, int K,
                                  int N, int out_f16, int passes,
                                  void* stream) {
  if (T <= 0 || K <= 0 || (passes != 1 && passes != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A_panels);
  const float* b = static_cast<const float*>(Bt);
  const int* p = static_cast<const int*>(panel);
  const int* c = static_cast<const int*>(cols);
  const bool vec = vector_path(a, b, K);
#define BSMR_LAUNCH_AT(PH, BW, P)                                             \
  return out_f16                                                              \
             ? launch<PH, BW, P, __half>(a, b, p, c, out, T, K, N, vec, s)    \
             : launch<PH, BW, P, float>(a, b, p, c, out, T, K, N, vec, s);
#define BSMR_LAUNCH(PH, BW)                                                   \
  if (ph == PH && bw == BW) {                                                 \
    if (passes == 1) BSMR_LAUNCH_AT(PH, BW, 1)                                \
    BSMR_LAUNCH_AT(PH, BW, 3)                                                 \
  }
  BSMR_MMA_FOR_EACH_GEOMETRY(BSMR_LAUNCH)
#undef BSMR_LAUNCH
#undef BSMR_LAUNCH_AT
  return static_cast<int>(cudaErrorInvalidValue);
}
