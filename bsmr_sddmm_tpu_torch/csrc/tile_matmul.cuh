// One (PH x BW) output tile of a block-sparse SDDMM, computed by one thread
// block in fp32 (FFMA). Shared by bsr_dense.cu, subpack.cu and
// gathered_tile.cu, which differ only in where the BW rows of the tile's B
// operand come from.
//
//   out[r][c] = sum_k a[r][k] * b_row(c)[k]
//
// a      : the tile's A panel, PH contiguous rows of K floats.
// b_row  : functor, column c -> pointer to K floats (a row of B^T), or
//          nullptr when that row lies past the end of B^T and reads as zero.
//
// Design: 256 threads = 8 row groups x 32 column lanes; thread (g, l) owns
// rows g + 8i and columns l + 32j, so PH/8 x BW/32 accumulators. K is walked
// in chunks of kChunk: the A panel chunk and the B chunk are staged through
// shared memory (stored K-major with one pad column, so both the coalesced
// global loads and the inner-loop reads are free of bank conflicts); within
// a warp all lanes read one A value (a broadcast) and 32 consecutive B
// values.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace bsmr {

constexpr int kThreads = 256;
constexpr int kChunk = 32;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

template <int PH, int BW, typename OutT, typename BRow>
__device__ __forceinline__ void tile_matmul(const float* __restrict__ a,
                                            BRow b_row, int K,
                                            OutT* __restrict__ out) {
  static_assert(PH % 8 == 0 && BW % 32 == 0, "tile geometry");
  constexpr int RPT = PH / 8;
  constexpr int CPT = BW / 32;
  __shared__ float As[kChunk][PH + 1];
  __shared__ float Bs[kChunk][BW + 1];
  __shared__ const float* rows[BW];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int grp = tid >> 5;
  for (int c = tid; c < BW; c += kThreads) rows[c] = b_row(c);

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    for (int idx = tid; idx < PH * kChunk; idx += kThreads) {
      const int r = idx / kChunk, kk = idx % kChunk, k = k0 + kk;
      As[kk][r] = k < K ? a[static_cast<size_t>(r) * K + k] : 0.f;
    }
    for (int idx = tid; idx < BW * kChunk; idx += kThreads) {
      const int c = idx / kChunk, kk = idx % kChunk, k = k0 + kk;
      const float* row = rows[c];
      Bs[kk][c] = (row != nullptr && k < K) ? row[k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      float av[RPT], bv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) av[i] = As[kk][grp + 8 * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) bv[j] = Bs[kk][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      store(out + static_cast<size_t>(grp + 8 * i) * BW + lane + 32 * j,
            acc[i][j]);
}

}  // namespace bsmr

// Instantiates LAUNCH(PH, BW) for every tile geometry the kernels take;
// the Python wrappers check the same set (ops/dense_kernels.py).
#define BSMR_FOR_EACH_GEOMETRY(LAUNCH) \
  LAUNCH(8, 128)                       \
  LAUNCH(16, 128)                      \
  LAUNCH(32, 128)                      \
  LAUNCH(64, 128)                      \
  LAUNCH(8, 256)                       \
  LAUNCH(16, 256)                      \
  LAUNCH(32, 256)                      \
  LAUNCH(64, 256)
