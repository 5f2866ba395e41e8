// Residual tier of the SDDMM body: one dot product per nonzero,
//
//   out[e] = sum_k A_perm[res_arow[e], k] * Bt[res_col[e], k],   e < E,
//
// each pair of rows read straight from the operands, so no (E, K) copy of
// gathered rows or of their products ever exists. It replaces no Pallas
// kernel: the JAX body leaves the residual to XLA (two jnp.take, a multiply
// and a sum, bsmr_sddmm_tpu/ops/sddmm.py:515-527), as the port's plain
// version leaves it to torch (index_select twice, a multiply, a sum). Its
// counterpart in the CUDA original is
// sddmm_gpu_sparse_block_2_2threadOneData_shuffle (src/sddmmKernel.cu:1994):
// a few threads per nonzero, float4 loads, partial sums joined by
// __shfl_xor_sync.
//
// What bounds it: bytes. Per nonzero two K-float rows are read, 8 bytes of
// index and one value written; the products are 2 * E * K fp32 FMAs, far
// below the bytes' time. The torch ops it replaces
// write the two gathered rows and their product to device memory and read
// them back (about 163 MB a call for E = 53 248 at K = 128, against at most
// 37 MB of distinct rows). The design: a group of L = min(32, K / 4) lanes
// (a power of two) takes one nonzero, each lane 16-byte loads of both rows
// (one load an operand at K = 128, two at K = 256; at K = 64 a half-warp a
// nonzero), its partial sum joined with the group's by __shfl_xor_sync.
// Each group keeps kUnroll nonzeros' loads in flight before the first FMA,
// and a warp walks its share of nonzeros under a grid-stride loop, so the
// card holds enough bytes in flight at E of a few ten thousand. The
// packer orders the residual by row panel (pack.pack_tiles), so neighbouring
// nonzeros share A rows; loads go through the read-only path and allocate
// in L1, where a block finds the rows of its neighbours. Where K % 4 != 0
// or a base pointer is not 16-byte aligned (tile_mma.cuh: vector_path),
// each lane loads one float at a time, L = min(32, K) lanes a nonzero.
//
// Arithmetic: fp32 FMA at every matmul_precision (no TF32: the torch
// residual it replaces is an elementwise product and a sum, which no TF32
// setting reaches); the sum is taken in another order than torch's, so the
// two agree to a few fp32 ulps, not bit for bit. The output is fp32 or
// fp16 (rounded once from the fp32 sum, as the plain version's cast).
//
// Indices are the plan's own (pack.pack_tiles: pad entries repeat row and
// column 0), each inside its operand. Launches on the stream it is given,
// allocates nothing and does not synchronise, so it runs on the body's side
// stream and inside captured CUDA graphs. Plain C interface for ctypes;
// returns the first CUDA error of the launch.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // nonzeros a lane group has in flight
constexpr int kBlocksPerSm = 2048 / kThreads;  // an SM's threads at most

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

// L lanes a nonzero; VEC: 16-byte loads (K % 4 == 0, aligned operands).
template <int L, bool VEC, typename OutT>
__global__ void __launch_bounds__(kThreads)
    residual_dot_kernel(const float* __restrict__ A,
                        const float* __restrict__ Bt,
                        const int* __restrict__ arow,
                        const int* __restrict__ col, OutT* __restrict__ out,
                        int E, int K) {
  constexpr int kGroups = 32 / L;              // nonzeros a warp side by side
  constexpr int kPerWarp = kGroups * kUnroll;  // nonzeros a warp takes a step
  const int lane = threadIdx.x % 32;
  const int g = lane / L, l = lane % L;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int loads = VEC ? K / 4 : K;  // loads of one row
  // the loop bound is the same for every lane of a warp, so each full-warp
  // shuffle below is reached by all 32 lanes
  for (int64_t base = warp * kPerWarp; base < E; base += warps * kPerWarp) {
    const float* a[kUnroll];
    const float* b[kUnroll];
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // a nonzero past E reads row 0 of each operand and is never stored
      const int64_t e = base + u * kGroups + g;
      const bool real = e < E;
      a[u] = A + (real ? static_cast<int64_t>(__ldg(arow + e)) * K : 0);
      b[u] = Bt + (real ? static_cast<int64_t>(__ldg(col + e)) * K : 0);
      acc[u] = 0.f;
    }
    for (int j = l; j < loads; j += L) {
      if constexpr (VEC) {
        float4 x[kUnroll], y[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          x[u] = __ldg(reinterpret_cast<const float4*>(a[u]) + j);
          y[u] = __ldg(reinterpret_cast<const float4*>(b[u]) + j);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          acc[u] = fmaf(x[u].x, y[u].x, acc[u]);
          acc[u] = fmaf(x[u].y, y[u].y, acc[u]);
          acc[u] = fmaf(x[u].z, y[u].z, acc[u]);
          acc[u] = fmaf(x[u].w, y[u].w, acc[u]);
        }
      } else {
        float x[kUnroll], y[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          x[u] = __ldg(a[u] + j);
          y[u] = __ldg(b[u] + j);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc[u] = fmaf(x[u], y[u], acc[u]);
      }
    }
    // join the group's partial sums: an xor below L stays inside the group
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int m = L / 2; m > 0; m /= 2)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], m);
    }
    // every lane holds its group's sums; lane u % L stores nonzero u, so a
    // warp's stores cover kPerWarp consecutive values
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = base + u * kGroups + g;
      if (l == u % L && e < E) store(out + e, acc[u]);
    }
  }
}

template <int L, bool VEC, typename OutT>
int launch(const float* a, const float* b, const int* r, const int* c,
           void* out, int E, int K, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough blocks for one step of every warp, at most kBlocksPerSm an SM;
  // the grid-stride loop takes the rest
  constexpr int kPerBlock = (kThreads / 32) * (32 / L) * kUnroll;
  const int64_t want = (static_cast<int64_t>(E) + kPerBlock - 1) / kPerBlock;
  const int64_t held = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int grid = static_cast<int>(want < held ? want : held);
  residual_dot_kernel<L, VEC, OutT><<<grid, kThreads, 0, s>>>(
      a, b, r, c, static_cast<OutT*>(out), E, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC, typename OutT>
int by_lanes(const float* a, const float* b, const int* r, const int* c,
             void* out, int E, int K, cudaStream_t s) {
  const int loads = VEC ? K / 4 : K;
  if (loads >= 32) return launch<32, VEC, OutT>(a, b, r, c, out, E, K, s);
  if (loads >= 16) return launch<16, VEC, OutT>(a, b, r, c, out, E, K, s);
  if (loads >= 8) return launch<8, VEC, OutT>(a, b, r, c, out, E, K, s);
  if (loads >= 4) return launch<4, VEC, OutT>(a, b, r, c, out, E, K, s);
  if (loads >= 2) return launch<2, VEC, OutT>(a, b, r, c, out, E, K, s);
  return launch<1, VEC, OutT>(a, b, r, c, out, E, K, s);
}

template <typename OutT>
int by_path(const float* a, const float* b, const int* r, const int* c,
             void* out, int E, int K, cudaStream_t s) {
  return bsmr::vector_path(a, b, K)
             ? by_lanes<true, OutT>(a, b, r, c, out, E, K, s)
             : by_lanes<false, OutT>(a, b, r, c, out, E, K, s);
}

}  // namespace

// A_perm (rows, K) and Bt (N, K): contiguous fp32; res_arow, res_col: (E,)
// int32 row ids of each; out: (E,) fp32, or fp16 where out_f16.
extern "C" int bsmr_residual(const void* A_perm, const void* Bt,
                             const void* res_arow, const void* res_col,
                             void* out, int E, int K, int out_f16,
                             void* stream) {
  if (E <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(A_perm);
  const float* b = static_cast<const float*>(Bt);
  const int* r = static_cast<const int*>(res_arow);
  const int* c = static_cast<const int*>(res_col);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f16 ? by_path<__half>(a, b, r, c, out, E, K, s)
                 : by_path<float>(a, b, r, c, out, E, K, s);
}
