// Tensor-core arithmetic core of the dense BSR tier (bsr_dense.cu), of the
// gathered-column tiles (gathered_tile.cu) and of the hot-column packed
// tiles (subpack.cu) on sm_90a: one (PH x BW) output tile
//
//   out[r][c] = sum_k a[r][k] * b_row(c)[k]
//
// computed by 4 or 8 warps with mma.sync.m16n8k8 (TF32 operands, fp32 sums).
//
// Numerics: three TF32 passes. Every operand value x is split
//   hi = cvt.rna.tf32(x),  lo = cvt.rna.tf32(x - hi)
// and a product is  a_lo*b_hi + a_hi*b_lo + a_hi*b_hi  (small terms first).
// Only the lo*lo term (~2^-22 relative per product) is dropped, so the result
// keeps about fp32 accuracy; it is the card's form of the JAX package's own
// three-pass split (ah@bh + ah@bl + al@bh, ops/pallas_dense.py). Raw fp32
// bits never reach the MMA, which would truncate them.
//
// Shared-memory layout: both operands are K-major, as they are in device
// memory: row r of a panel or of B^T holds its K values at [r * stride + k],
// stride = (K rounded up to 8) + 4 floats, or 32 + 4 for one K-chunk. The
// stride is 4 * (an odd number), so the 8 rows x 16 bytes that one block of
// an ldmatrix fragment load touches fall into 32 different banks: fragment
// reads are free of bank conflicts without a swizzle, and every row start
// stays 16-byte aligned for the copies and for ldmatrix.
//
// Copies: cp.async.ca, 16 bytes a thread where K % 4 == 0 (rows are then
// 16-byte aligned), 4 bytes a thread otherwise (the second load path, same
// layout, same pipeline). The zfill form writes zeros for rows that do not
// exist (past the end of B^T, a column id outside [0, N)) and for the K
// tail. (.ca, not .cg: on an H100 the gathered tiles, whose neighbours share
// rows, ran 2.2-3.2x slower with copies that bypass L1; the dense tier ran
// the same.)
//
// Warp tiling: a warp owns 32 rows (16 for panels of 8 or 16 rows) by BW / 4
// columns, so a tile takes 4 warps, or 8 for panels of 64 rows. Per step of
// 8 along K a warp of a (32 x 128) tile loads 4 fragments (ldmatrix.x4) for
// 24 MMAs; a smaller warp tile is bound by shared-memory reads instead of by
// the tensor cores. A panel of 8 rows is computed as 16 (MMA rows are
// independent; the upper 8 are never stored).
//
// Epilogue: lanes exchange accumulator halves by shuffle so that every lane
// holds 4 consecutive fp32 (8 consecutive fp16) of one row, and writes them
// with one 16-byte streaming store (st.global.cs), which keeps the output
// stream from evicting the operands from L2.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace bsmr {

constexpr int kPadK = 4;       // floats of padding per shared-memory row
constexpr int kChunkK = 32;    // K-chunk of the streaming pipeline
constexpr int kChunkStride = kChunkK + kPadK;
constexpr int kStreamStages = 2;  // ring stages of that pipeline
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr int kGroupJ = 4;     // n8 tiles whose B fragments a warp holds

template <int PH, int BW>
struct Tiling {
  static_assert(PH % 8 == 0 && BW % 128 == 0, "tile geometry");
  static constexpr int PHP = PH < 16 ? 16 : PH;     // rows computed
  static constexpr int WARPS = PHP >= 64 ? 8 : 4;   // warps that share a tile
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int WN = 4;                      // warps along columns
  static constexpr int WM = WARPS / WN;             // warps along rows
  static constexpr int MI = PHP / (16 * WM);        // m16 tiles per warp
  static constexpr int NJ = BW / (8 * WN);          // n8 tiles per warp
  static_assert(NJ % kGroupJ == 0, "B fragments are held kGroupJ at a time");
};

// ---------------------------------------------------------------------------
// TF32 split, fragment loads and MMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Four 8 x 4 blocks of 32-bit values (8 rows of 16 bytes each; lane l gives
// the address of row l % 8 of block l / 8); lane (g, t) receives element t of
// row g of each block, which is the TF32 fragment layout of mma.m16n8k8 for
// K-major operands.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// Not volatile: the MMAs are ordered by their accumulators alone, so the
// fragment loads of the next step are free to move above them.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// Asynchronous copies
// ---------------------------------------------------------------------------

// Copies BYTES (16 or 4) from device to shared memory, or writes BYTES of
// zeros when !valid (src is then not read but must be a device address).
template <int BYTES>
__device__ __forceinline__ void cp_async(float* smem, const float* src,
                                         bool valid) {
  static_assert(BYTES == 16 || BYTES == 4, "cp.async size");
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const size_t g = __cvta_generic_to_global(src);
  const int n = valid ? BYTES : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst),
               "l"(g), "n"(BYTES), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Stages nrows x kcols floats into shared memory (row r at smem + r*stride)
// with NT threads, of which the caller is number tid: columns
// [k0, k0 + kcols) of the rows row(r); a null row, and columns at or past K,
// read as zero. VEC floats a copy; kcols % VEC == 0, and with VEC = 4
// K % 4 == 0 and 16-byte aligned rows. `safe` is any device address.
template <int NT, int VEC, typename RowFn>
__device__ __forceinline__ void stage_rows_by(int tid, float* smem,
                                              int stride, int nrows,
                                              int kcols, int k0, int K,
                                              RowFn row, const float* safe) {
  const int per_row = kcols / VEC;
  for (int idx = tid; idx < nrows * per_row; idx += NT) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * VEC;
    const float* p = row(r);
    const bool ok = p != nullptr && k0 + c < K;
    cp_async<VEC * 4>(smem + r * stride + c, ok ? p + k0 + c : safe, ok);
  }
}

// The same with 16-byte copies (vec) or 4-byte copies.
template <int NT, typename RowFn>
__device__ __forceinline__ void stage_rows(bool vec, int tid, float* smem,
                                           int stride, int nrows, int kcols,
                                           int k0, int K, RowFn row,
                                           const float* safe) {
  if (vec)
    stage_rows_by<NT, 4>(tid, smem, stride, nrows, kcols, k0, K, row, safe);
  else
    stage_rows_by<NT, 1>(tid, smem, stride, nrows, kcols, k0, K, row, safe);
}

// ---------------------------------------------------------------------------
// The warp's share of a tile over `ksteps` steps of 8 along K
// ---------------------------------------------------------------------------

// The warp's share of a tile over `ksteps` steps of 8 along K.
// As: the warp's first panel row, Bs: the warp's first B^T row, both at
// k = 0 of the slab, rows `stride` floats apart. Both operands are read raw
// and split into hi / lo here. Within a step the three passes run one
// after the other over the accumulators of kGroupJ n8 tiles, so that two
// MMAs on one accumulator are MI * kGroupJ MMAs apart and none waits for the
// one before it. The order of loads and conversions against the MMAs is
// left to the compiler over four unrolled steps (prefetching the next
// step's fragments by hand was slower on an H100).
template <int MI, int NJ>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NJ][4],
                                         const float* As, const float* Bs,
                                         int stride, int ksteps) {
  const int lane = threadIdx.x & 31;
  const float* ap =
      As + ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + (lane >> 4) * 4;
  const float* bp =
      Bs + ((lane & 7) + (lane >> 4) * 8) * stride + ((lane >> 3) & 1) * 4;
#pragma unroll 4
  for (int ks = 0; ks < ksteps; ++ks, ap += 8, bp += 8) {
    uint32_t ahi[MI][4], alo[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      uint32_t raw[4];
      ldmatrix_x4(raw, ap + 16 * i * stride);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tf32_split(__uint_as_float(raw[e]), ahi[i][e], alo[i][e]);
    }
#pragma unroll
    for (int jg = 0; jg < NJ; jg += kGroupJ) {
      // fragments of kGroupJ n8 tiles, two tiles a load
      uint32_t bhi[kGroupJ][2], blo[kGroupJ][2];
#pragma unroll
      for (int j = 0; j < kGroupJ; j += 2) {
        uint32_t h[4], l[4];
        ldmatrix_x4(h, bp + 8 * (jg + j) * stride);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32_split(__uint_as_float(h[e]), h[e], l[e]);
        bhi[j][0] = h[0], bhi[j][1] = h[1];
        bhi[j + 1][0] = h[2], bhi[j + 1][1] = h[3];
        blo[j][0] = l[0], blo[j][1] = l[1];
        blo[j + 1][0] = l[2], blo[j + 1][1] = l[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < kGroupJ; ++j)
          mma_tf32(acc[i][jg + j], alo[i], bhi[j]);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < kGroupJ; ++j)
          mma_tf32(acc[i][jg + j], ahi[i], blo[j]);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < kGroupJ; ++j)
          mma_tf32(acc[i][jg + j], ahi[i], bhi[j]);
    }
  }
}

template <int MI, int NJ>
__device__ __forceinline__ void zero_acc(float (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// ---------------------------------------------------------------------------
// Epilogue
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 shfl_xor4(float4 v, int mask) {
  v.x = __shfl_xor_sync(0xffffffffu, v.x, mask);
  v.y = __shfl_xor_sync(0xffffffffu, v.y, mask);
  v.z = __shfl_xor_sync(0xffffffffu, v.z, mask);
  v.w = __shfl_xor_sync(0xffffffffu, v.w, mask);
  return v;
}

// An m16n8 accumulator gives lane (g, t) the columns 2t, 2t+1 of rows g and
// g + 8. After one exchange with lane t ^ 1, an even t holds columns
// 4*(t/2) .. +3 of row g and an odd t the same columns of row g + 8.
__device__ __forceinline__ float4 quad_of(const float (&c)[4], bool odd) {
  const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
  return odd ? make_float4(r0, r1, c[2], c[3])
             : make_float4(c[0], c[1], r0, r1);
}

__device__ __forceinline__ uint32_t pack_half2(float a, float b) {
  const __half2 h = __halves2half2(__float2half_rn(a), __float2half_rn(b));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Stores the warp's accumulators into the tile `out` (PH rows of BW values);
// the warp's first row and column are row0 and col0.
template <int PH, int BW, int MI, int NJ, typename OutT>
__device__ __forceinline__ void store_tile(const float (&acc)[MI][NJ][4],
                                           OutT* __restrict__ out, int row0,
                                           int col0) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const bool odd = t & 1;
  const bool upper = t & 2;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = row0 + 16 * i + (lane >> 2) + (odd ? 8 : 0);
    if constexpr (std::is_same<OutT, float>::value) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 v = quad_of(acc[i][j], odd);
        if (row < PH)
          __stcs(reinterpret_cast<float4*>(out + static_cast<size_t>(row) * BW +
                                           col0 + 8 * j + (upper ? 4 : 0)),
                 v);
      }
    } else {
      // a second exchange, with lane t ^ 2, over a pair of n8 tiles: the
      // lower lane keeps all 8 columns of tile j, the upper lane of j + 1
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        const float4 v0 = quad_of(acc[i][j], odd);
        const float4 v1 = quad_of(acc[i][j + 1], odd);
        const float4 got = shfl_xor4(upper ? v0 : v1, 2);
        const float4 lo = upper ? got : v0;
        const float4 hi = upper ? v1 : got;
        const uint4 packed =
            make_uint4(pack_half2(lo.x, lo.y), pack_half2(lo.z, lo.w),
                       pack_half2(hi.x, hi.y), pack_half2(hi.z, hi.w));
        if (row < PH)
          __stcs(reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * BW +
                                          col0 + 8 * (j + (upper ? 1 : 0))),
                 packed);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Streaming tile: K walked in chunks of 32 through a 2-stage cp.async ring
// ---------------------------------------------------------------------------

// Dynamic shared memory of a streaming block at depth K: one stage per
// K-chunk, at most kStreamStages of them.
template <int PH, int BW>
inline int stream_smem_bytes(int K) {
  const int chunks = (K + kChunkK - 1) / kChunkK;
  return (chunks < kStreamStages ? chunks : kStreamStages) *
         (Tiling<PH, BW>::PHP + BW) * kChunkStride *
         static_cast<int>(sizeof(float));
}

// One tile by one thread block of Tiling<PH, BW>::THREADS threads, for any
// K: the A panel `a` (PH contiguous rows of K floats) and the BW rows
// b_row(c) of B^T (nullptr: a row of zeros) stream through shared memory
// chunk by chunk, the next chunk in flight under the MMAs of this one (two
// stages of 23 KB at (32, 128) let four blocks share an SM, which ran 8-10%
// faster than three blocks of three stages); both operands are split on the
// fly and the sums stay in registers. `smem` is
// stream_smem_bytes<PH, BW>(K) of dynamic shared memory, 16-byte aligned.
// `vec` (16-byte copies) needs K % 4 == 0 and 16-byte aligned operands;
// without it any K is taken.
template <int PH, int BW, typename OutT, typename BRow>
__device__ __forceinline__ void tile_mma_stream(const float* __restrict__ a,
                                                BRow b_row, int K, bool vec,
                                                OutT* __restrict__ out,
                                                float* smem,
                                                const float* safe) {
  using TL = Tiling<PH, BW>;
  constexpr int kStage = (TL::PHP + BW) * kChunkStride;
  __shared__ const float* rows[BW];
  for (int c = threadIdx.x; c < BW; c += TL::THREADS) rows[c] = b_row(c);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int row0 = (warp % TL::WM) * 16 * TL::MI;
  const int col0 = (warp / TL::WM) * 8 * TL::NJ;
  const int chunks = (K + kChunkK - 1) / kChunkK;
  auto fill = [&](int chunk) {
    if (chunk < chunks) {
      float* As = smem + (chunk % kStreamStages) * kStage;
      float* Bs = As + TL::PHP * kChunkStride;
      const int k0 = chunk * kChunkK;
      stage_rows<TL::THREADS>(
          vec, threadIdx.x, As, kChunkStride, PH, kChunkK, k0, K,
          [=](int r) { return a + static_cast<size_t>(r) * K; }, safe);
      stage_rows<TL::THREADS>(vec, threadIdx.x, Bs, kChunkStride, BW, kChunkK,
                              k0, K, [&](int c) { return rows[c]; }, safe);
    }
    cp_async_commit();
  };

  float acc[TL::MI][TL::NJ][4];
  zero_acc(acc);
#pragma unroll
  for (int s = 0; s < kStreamStages - 1; ++s) fill(s);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStreamStages - 2>();   // chunk c has landed
    __syncthreads();                      // ... for every thread, and the
                                          // stage of chunk c - 1 is free
    fill(c + kStreamStages - 1);
    const float* As = smem + (c % kStreamStages) * kStage;
    const float* Bs = As + TL::PHP * kChunkStride;
    warp_mma<TL::MI, TL::NJ>(acc, As + row0 * kChunkStride,
                             Bs + col0 * kChunkStride, kChunkStride,
                             kChunkK / 8);
  }
  store_tile<PH, BW>(acc, out, row0, col0);
}

// A kernel instantiation's limit of dynamic shared memory, raised once per
// device (a launch above 48 KB is refused without it) and again only when a
// launch needs more. One object per instantiation: a static of its launch
// function. Launches may come from several host threads.
constexpr int kMaxDevices = 64;
struct SmemLimit {
  std::mutex mu;
  int allowed[kMaxDevices] = {};

  // Allows `bytes` on the current device, whose number goes to *device.
  template <typename Kern>
  cudaError_t raise(Kern kern, int bytes, int* device) {
    cudaError_t err = cudaGetDevice(device);
    if (err != cudaSuccess) return err;
    if (*device < 0 || *device >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu);
    if (allowed[*device] < bytes) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err == cudaSuccess) allowed[*device] = bytes;
    }
    return err;
  }
};

// True when the 16-byte copy path applies to operands a and b of depth K.
inline bool vector_path(const void* a, const void* b, int K) {
  return K % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
                 16 == 0;
}

}  // namespace bsmr

// Instantiates LAUNCH(PH, BW) for every tile geometry the kernels take;
// the Python wrappers check the same set (ops/dense_kernels.py).
#define BSMR_MMA_FOR_EACH_GEOMETRY(LAUNCH) \
  LAUNCH(8, 128)                           \
  LAUNCH(16, 128)                          \
  LAUNCH(32, 128)                          \
  LAUNCH(64, 128)                          \
  LAUNCH(8, 256)                           \
  LAUNCH(16, 256)                          \
  LAUNCH(32, 256)                          \
  LAUNCH(64, 256)
