// Gathered-column tiles of the SDDMM body: one thread block per tile, whose
// B operand is BW rows of Bt picked by index,
//
//   out[t] = A_panels[panel[t]] . Bt[cols[t*BW : (t+1)*BW]]^T.
//
// Replaces two of the JAX package's Pallas kernels in
// bsmr_sddmm_tpu/ops/pallas_dense.py, which compute this same function:
// make_dense_tile_kernel (the col_mode="reorder" dense tier, fed B tiles
// that XLA gathered beforehand) and make_fused_gathered_kernel (the fused
// gathered tier, whose row DMAs are issued by hand inside the kernel). Here
// the thread block reads its tile's B rows by index straight from device
// memory while it stages them through shared memory (tile_matmul.cuh), so no
// (T, BW, K) copy of gathered rows is ever materialised: the plain version's
// copy is 235 MB at T = 3584, K = 128. A B row is K contiguous floats, so
// each row read stays coalesced; rows shared between tiles are re-read from
// L2. Like the other two kernels, this first design is expected to be bound
// by its FFMA inner loop rather than by the gather.
//
// Column ids need not be sorted or unique (pad tiles repeat one column). An
// id outside [0, N) reads as zero, as rows past the end of B do in the other
// two kernels. Plain C interface for ctypes; returns cudaGetLastError()
// after the launch.
#include "tile_matmul.cuh"

namespace {

template <int PH, int BW, typename OutT>
__global__ void __launch_bounds__(bsmr::kThreads)
    gathered_tile_kernel(const float* __restrict__ A_panels,
                         const float* __restrict__ Bt,
                         const int* __restrict__ panel,
                         const int* __restrict__ cols, OutT* __restrict__ out,
                         int K, int N) {
  const int t = blockIdx.x;
  const float* a = A_panels + static_cast<size_t>(panel[t]) * PH * K;
  const int* tile_cols = cols + static_cast<size_t>(t) * BW;
  auto b_row = [=](int c) -> const float* {
    const int n = tile_cols[c];
    return (n >= 0 && n < N) ? Bt + static_cast<size_t>(n) * K : nullptr;
  };
  bsmr::tile_matmul<PH, BW>(a, b_row, K,
                            out + static_cast<size_t>(t) * PH * BW);
}

}  // namespace

extern "C" int bsmr_gathered_tile(const void* A_panels, const void* Bt,
                                  const void* panel, const void* cols,
                                  void* out, int T, int ph, int bw, int K,
                                  int N, int out_f16, void* stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A_panels);
  const float* b = static_cast<const float*>(Bt);
  const int* p = static_cast<const int*>(panel);
  const int* c = static_cast<const int*>(cols);
#define BSMR_LAUNCH(PH, BW)                                                  \
  if (ph == PH && bw == BW) {                                                \
    if (out_f16)                                                             \
      gathered_tile_kernel<PH, BW, __half><<<T, bsmr::kThreads, 0, s>>>(     \
          a, b, p, c, static_cast<__half*>(out), K, N);                      \
    else                                                                     \
      gathered_tile_kernel<PH, BW, float><<<T, bsmr::kThreads, 0, s>>>(      \
          a, b, p, c, static_cast<float*>(out), K, N);                       \
    return static_cast<int>(cudaGetLastError());                             \
  }
  BSMR_FOR_EACH_GEOMETRY(BSMR_LAUNCH)
#undef BSMR_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
