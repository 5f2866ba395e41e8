// Hot-column packed tier of the SDDMM body: one thread block per packed
// tile, whose B operand is S = BW/sw contiguous sw-row slices of the
// hot-column-permuted Bt2 = Bt[sp_colperm],
//
//   out[t] = A_panels[sp_panel[t]] . concat_s(Bt2[sp_sub[t,s]*sw : +sw])^T.
//
// Replaces the JAX package's Pallas kernel make_subpack_kernel in
// bsmr_sddmm_tpu/ops/pallas_dense.py. Sub-block rows at or past H read as
// zero, which takes the place of the JAX wrapper's pad of Bt2. Plain C
// interface for ctypes; returns cudaGetLastError() after the launch.
#include "tile_matmul.cuh"

namespace {

template <int PH, int BW, typename OutT>
__global__ void __launch_bounds__(bsmr::kThreads)
    subpack_kernel(const float* __restrict__ A_panels,
                   const float* __restrict__ Bt2,
                   const int* __restrict__ sp_panel,
                   const int* __restrict__ sp_sub, OutT* __restrict__ out,
                   int S, int sw, int K, int H) {
  const int t = blockIdx.x;
  const float* a = A_panels + static_cast<size_t>(sp_panel[t]) * PH * K;
  const int* sub = sp_sub + static_cast<size_t>(t) * S;
  auto b_row = [=](int c) -> const float* {
    const long long h = static_cast<long long>(sub[c / sw]) * sw + c % sw;
    return h < H ? Bt2 + h * K : nullptr;
  };
  bsmr::tile_matmul<PH, BW>(a, b_row, K,
                            out + static_cast<size_t>(t) * PH * BW);
}

}  // namespace

extern "C" int bsmr_subpack(const void* A_panels, const void* Bt2,
                            const void* sp_panel, const void* sp_sub,
                            void* out, int Tp, int S, int sw, int ph, int bw,
                            int K, int H, int out_f16, void* stream) {
  if (Tp <= 0 || S <= 0 || S * sw != bw)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A_panels);
  const float* b = static_cast<const float*>(Bt2);
  const int* sp = static_cast<const int*>(sp_panel);
  const int* sb = static_cast<const int*>(sp_sub);
#define BSMR_LAUNCH(PH, BW)                                                  \
  if (ph == PH && bw == BW) {                                                \
    if (out_f16)                                                             \
      subpack_kernel<PH, BW, __half><<<Tp, bsmr::kThreads, 0, s>>>(          \
          a, b, sp, sb, static_cast<__half*>(out), S, sw, K, H);             \
    else                                                                     \
      subpack_kernel<PH, BW, float><<<Tp, bsmr::kThreads, 0, s>>>(           \
          a, b, sp, sb, static_cast<float*>(out), S, sw, K, H);              \
    return static_cast<int>(cudaGetLastError());                             \
  }
  BSMR_FOR_EACH_GEOMETRY(BSMR_LAUNCH)
#undef BSMR_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
