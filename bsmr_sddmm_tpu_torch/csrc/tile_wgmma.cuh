// Warpgroup MMA (wgmma) pieces of the dense BSR tier's resident route
// (bsr_dense.cu) on sm_90a; tile_mma.cuh has the numerics, the copies, the
// A-fragment loads and the epilogue they are used with.
//
// A warpgroup (4 warps) multiplies 64 rows of A, held in registers as
// TF32 fragments (each warp 16 rows, the layout of mma.m16n8k8), by NW rows
// of B^T read by the tensor cores straight from shared memory, 8 along K
// an instruction; the sums (64 x NW, fp32) stay in registers, each warp's
// in the layout of NW / 8 m16n8 accumulators.
//
// Shared-memory layout of B for that: K-major in 128-byte-swizzled slabs.
// A slab holds 32 floats of K for every row: row n at n * 128 bytes, its
// eight 16-byte chunks stored at chunk ^ (n % 8). The slabs of a block
// follow each other, and a block starts on a 1024-byte boundary, since the
// swizzle is a function of the address. 16-byte cp.async copies write this
// layout directly, so no tensor map (TMA) is needed; writes made by threads
// (the copies, the hi / lo split) are fenced (fence.proxy.async) before the
// tensor cores read them.
#pragma once

#include "tile_mma.cuh"

namespace bsmr {

constexpr int kSlabK = 32;  // floats of K in a swizzled slab row (128 bytes)

// Offset in floats of element (n, k) of a block of `rows` rows.
__device__ __forceinline__ int swizzled(int n, int k, int rows) {
  const int chunk = ((k & (kSlabK - 1)) >> 2) ^ (n & 7);
  return (k / kSlabK) * rows * kSlabK + n * kSlabK + (chunk << 2) + (k & 3);
}

// Stages `rows` rows of K floats into a swizzled block of depth K32 (K
// rounded up to 32) with NT threads, of which the caller is number tid; a
// null row(n), and columns at or past K, read as zero. VEC floats a copy,
// as stage_rows_by.
template <int NT, int VEC, typename RowFn>
__device__ __forceinline__ void stage_swizzled_by(int tid, float* smem,
                                                  int rows, int K32, int K,
                                                  RowFn row,
                                                  const float* safe) {
  const int per_row = K32 / VEC;
  for (int idx = tid; idx < rows * per_row; idx += NT) {
    const int n = idx / per_row;
    const int k = (idx - n * per_row) * VEC;
    const float* p = row(n);
    const bool ok = p != nullptr && k < K;
    cp_async<VEC * 4>(smem + swizzled(n, k, rows), ok ? p + k : safe, ok);
  }
}

template <int NT, typename RowFn>
__device__ __forceinline__ void stage_swizzled(bool vec, int tid, float* smem,
                                               int rows, int K32, int K,
                                               RowFn row, const float* safe) {
  if (vec)
    stage_swizzled_by<NT, 4>(tid, smem, rows, K32, K, row, safe);
  else
    stage_swizzled_by<NT, 1>(tid, smem, rows, K32, K, row, safe);
}

// Makes this thread's writes to shared memory visible to the tensor cores'
// reads (with a barrier after it, every thread's).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Descriptor of a swizzled K-major operand that starts at shared-memory byte
// address `addr`: rows 128 bytes apart, 8-row groups 1024 bytes apart. A
// step of 8 along K inside a slab adds 32 bytes to the address.
__device__ __forceinline__ uint64_t swizzled_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins registers in program order against the asynchronous MMAs around it.
template <int NJ>
__device__ __forceinline__ void fence_acc(float (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d += a . B^T for the 64 x NW tile of a warpgroup, 8 along K: a is the
// warp's TF32 fragment of its 16 rows, b_desc the descriptor of NW rows.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

}  // namespace bsmr
