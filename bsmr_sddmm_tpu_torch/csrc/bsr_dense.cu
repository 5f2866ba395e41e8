// Dense BSR tier of the SDDMM body: one thread block per (panel, column
// block) tile,
//
//   out[t] = A_panels[tile_panel[t]] . Bt[cb*BW : (cb+1)*BW]^T,
//   cb = step_cblock[t / G].
//
// Replaces the JAX package's Pallas kernels make_bsr_fat_kernel (G > 1) and
// make_bsr_dense_kernel (G = 1, step_cblock = tile_cblock) in
// bsmr_sddmm_tpu/ops/pallas_dense.py. Rows of the last column block at or
// past N read as zero, which takes the place of the JAX wrapper's pad of Bt.
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.
#include "tile_matmul.cuh"

namespace {

template <int PH, int BW, typename OutT>
__global__ void __launch_bounds__(bsmr::kThreads)
    bsr_dense_kernel(const float* __restrict__ A_panels,
                     const float* __restrict__ Bt,
                     const int* __restrict__ tile_panel,
                     const int* __restrict__ step_cblock,
                     OutT* __restrict__ out, int G, int K, int N) {
  const int t = blockIdx.x;
  const float* a = A_panels + static_cast<size_t>(tile_panel[t]) * PH * K;
  const long long base = static_cast<long long>(step_cblock[t / G]) * BW;
  auto b_row = [=](int c) -> const float* {
    const long long n = base + c;
    return n < N ? Bt + n * K : nullptr;
  };
  bsmr::tile_matmul<PH, BW>(a, b_row, K,
                            out + static_cast<size_t>(t) * PH * BW);
}

}  // namespace

extern "C" int bsmr_bsr_dense(const void* A_panels, const void* Bt,
                              const void* tile_panel, const void* step_cblock,
                              void* out, int T, int G, int ph, int bw, int K,
                              int N, int out_f16, void* stream) {
  if (T <= 0 || G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A_panels);
  const float* b = static_cast<const float*>(Bt);
  const int* tp = static_cast<const int*>(tile_panel);
  const int* sc = static_cast<const int*>(step_cblock);
#define BSMR_LAUNCH(PH, BW)                                                  \
  if (ph == PH && bw == BW) {                                                \
    if (out_f16)                                                             \
      bsr_dense_kernel<PH, BW, __half><<<T, bsmr::kThreads, 0, s>>>(         \
          a, b, tp, sc, static_cast<__half*>(out), G, K, N);                 \
    else                                                                     \
      bsr_dense_kernel<PH, BW, float><<<T, bsmr::kThreads, 0, s>>>(          \
          a, b, tp, sc, static_cast<float*>(out), G, K, N);                  \
    return static_cast<int>(cudaGetLastError());                             \
  }
  BSMR_FOR_EACH_GEOMETRY(BSMR_LAUNCH)
#undef BSMR_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
