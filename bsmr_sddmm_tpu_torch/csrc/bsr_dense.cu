// Dense BSR tier of the SDDMM body:
//
//   out[t] = A_panels[tile_panel[t]] . Bt[cb*BW : (cb+1)*BW]^T,
//   cb = step_cblock[t / G].
//
// Replaces the JAX package's Pallas kernels make_bsr_fat_kernel (G > 1) and
// make_bsr_dense_kernel (G = 1, step_cblock = tile_cblock) in
// bsmr_sddmm_tpu/ops/pallas_dense.py. Rows of the last column block at or
// past N read as zero, which takes the place of the JAX wrapper's pad of Bt.
// Pad tiles are computed and stored like real ones.
//
// What bounds it: at (PH, BW, K) = (32, 128, 128) a tile is 3 * 2^20 TF32
// operations for 16 KB of output, and the operands are shared between tiles,
// so bytes (the output store) and tensor-core operations bind within a few
// percent of each other; at K = 32 the output store binds alone. The design
// keeps everything but the output store out of the way of the MMAs:
//
// * Resident route (G >= 2 and the block fits), on warpgroup MMAs
//   (tile_wgmma.cuh): the work is the list of units (fat step, 64 rows of
//   it: 2 tiles of 32 rows, 1 of 64, 4 of 16 or 8), in order, and each of
//   the persistent thread blocks (as many as the card holds at once) walks
//   one contiguous share of it. The step's column block (BW x K) is copied
//   into shared memory when the block reaches a new step, split once into
//   TF32 hi (in place) and lo (a second buffer), and reused for every unit
//   of that step: the tensor cores read it from shared memory without any
//   conversion, and a column block is read from L2 two or three times per
//   thread block, not once per tile. The A panels (PH x K, contiguous)
//   stream through a ring of 2 or 3 stages (a unit each) filled by cp.async
//   under the MMAs of the units before, across step boundaries too; each of
//   the block's two warpgroups multiplies the unit's 64 rows, split into hi
//   and lo in registers, by one half of the block's columns.
//   Shared memory: 2 * BW * K32 * 4 bytes (K32 = K rounded up to 32) plus
//   stages * 64 * (K8 + 4) * 4 (K8 = K rounded up to 8): 195 KB at
//   (32, 128, 128) with 2 stages, one block per SM; 60 KB at K = 32 with 3
//   stages, three blocks per SM.
// * Streaming route (G = 1, or a block too large to stay resident in both
//   halves beside a 2-stage ring: K above 128 at BW = 128, above 64 at
//   BW = 256), on mma.sync (tile_mma.cuh): one tile per thread block of 4
//   warps (8 for 64-row panels), both operands walked in K-chunks of 32
//   through a 2-stage cp.async ring and split on the fly (tile_mma_stream);
//   45 KB at (32, 128), four blocks per SM.
//
// Measured on an H100 (PERF.md): at K = 128 the resident route's MMA loop
// alone takes about 0.13 of its 0.18 ms, and the copies and the stores add
// to that instead of hiding under it (one block per SM, both warpgroups in
// step). Warp-specialised producers and TMA loads are the next step.
//
// Both routes take any K: where K % 4 != 0 (or an operand is not 16-byte
// aligned) the same pipelines copy 4 bytes a thread instead of 16.
// Plain C interface for ctypes; returns the first CUDA error of the launch.
#include "tile_wgmma.cuh"

namespace {

using namespace bsmr;

constexpr int kBlockWarps = 8;  // two warpgroups
constexpr int kBlockThreads = 32 * kBlockWarps;
constexpr int kUnitRows = 64;   // rows of A a warpgroup multiplies at a time

// Shared memory of the resident route at depth K with `stages` units of A
// in flight: the column block in both halves, swizzled slabs (K rounded up
// to 32) after up to 1024 bytes of alignment, and the ring's padded rows.
inline int resident_stride(int K) { return ((K + 7) & ~7) + kPadK; }
inline long long resident_bytes(int bw, int K, int stages) {
  const int K32 = (K + kSlabK - 1) / kSlabK * kSlabK;
  return 1024 + static_cast<long long>(sizeof(float)) *
                    (2LL * bw * K32 +
                     static_cast<long long>(stages) * kUnitRows *
                         resident_stride(K));
}

template <int PH, int BW, typename OutT>
__global__ void __launch_bounds__(kBlockThreads)
    bsr_resident_kernel(const float* __restrict__ A_panels,
                        const float* __restrict__ Bt,
                        const int* __restrict__ tile_panel,
                        const int* __restrict__ step_cblock,
                        OutT* __restrict__ out, int T, int G, int K, int N,
                        int stages, bool vec) {
  using TL = Tiling<PH, BW>;
  constexpr int kTiles = kUnitRows / TL::PHP;  // tiles of a unit
  constexpr int NW = BW / 2;                   // columns of a warpgroup
  constexpr int NJ = NW / 8;
  extern __shared__ __align__(16) unsigned char raw[];
  const int K8 = (K + 7) & ~7;
  const int K32 = (K + kSlabK - 1) / kSlabK * kSlabK;
  const int S = K8 + kPadK;
  const uint32_t raw_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  float* Bhi =  // on a 1024-byte boundary, as the swizzle needs
      reinterpret_cast<float*>(raw + (1024 - raw_addr % 1024) % 1024);
  float* Blo = Bhi + BW * K32;
  float* ring = Blo + BW * K32;
  const int slot = TL::PHP * S;  // floats of one panel in the ring

  // this block's share [lo, hi) of the units
  const int per_step = (G + kTiles - 1) / kTiles;
  const long long units = static_cast<long long>(T / G) * per_step;
  const int lo = static_cast<int>(units * blockIdx.x / gridDim.x);
  const int hi = static_cast<int>(units * (blockIdx.x + 1) / gridDim.x);

  // copies the panels of unit u into its stage; one group per call
  auto fill = [&](int u) {
    if (u < hi) {
      const int step = u / per_step;
      const int first = (u - step * per_step) * kTiles;
      float* dst = ring + ((u - lo) % stages) * kTiles * slot;
#pragma unroll
      for (int p = 0; p < kTiles; ++p)
        if (first + p < G) {
          const float* a =
              A_panels +
              static_cast<size_t>(tile_panel[step * G + first + p]) * PH * K;
          stage_rows<kBlockThreads>(
              vec, threadIdx.x, dst + p * slot, S, PH, K8, 0, K,
              [=](int r) { return a + static_cast<size_t>(r) * K; }, Bt);
        }
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages; ++s) fill(lo + s);

  // warp w of warpgroup wg: rows 16w .. 16w+15 of the unit, which are rows
  // row0 .. of its tile number `tile`; columns wg * NW .. of the block
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int w = warp & 3;
  const int tile = (16 * w) / TL::PHP;
  const int row0 = (16 * w) % TL::PHP;
  const int col0 = wg * NW;
  const int lane = threadIdx.x & 31;
  const int a_off = (16 * w + (lane & 7) + ((lane >> 3) & 1) * 8) * S +
                    (lane >> 4) * 4;  // the lane's ldmatrix row and column
  const uint32_t bhi_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(Bhi)) + col0 * 128;
  const uint32_t half_bytes = static_cast<uint32_t>(BW) * K32 * 4;

  int resident = -1;  // the step whose column block is in Bhi / Blo
  for (int u = lo; u < hi; ++u) {
    const int step = u / per_step;
    const int g = (u - step * per_step) * kTiles + tile;
    if (step != resident) {
      // every warp left the step before at the barrier that ends a unit
      resident = step;
      const long long base = static_cast<long long>(step_cblock[step]) * BW;
      stage_swizzled<kBlockThreads>(vec, threadIdx.x, Bhi, BW, K32, K,
                                    [=](int c) -> const float* {
                                      const long long n = base + c;
                                      return n < N ? Bt + n * K : nullptr;
                                    },
                                    Bt);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      // split the resident block once: hi in place, lo beside it
      for (int o = 4 * threadIdx.x; o < BW * K32; o += 4 * kBlockThreads) {
        const float4 x = *reinterpret_cast<const float4*>(Bhi + o);
        uint4 h, l;
        tf32_split(x.x, h.x, l.x);
        tf32_split(x.y, h.y, l.y);
        tf32_split(x.z, h.z, l.z);
        tf32_split(x.w, h.w, l.w);
        *reinterpret_cast<uint4*>(Bhi + o) = h;
        *reinterpret_cast<uint4*>(Blo + o) = l;
      }
      fence_proxy_async();
    } else if (stages == 3) {
      // one group is committed per unit, so all but the newest stages - 1
      // groups being complete means unit u has landed
      cp_async_wait<2>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();

    // 64 x NW sums of this warpgroup: per step of 8 along K three MMAs in
    // one group (a_lo.b_hi, a_hi.b_lo, a_hi.b_hi: small terms first); the
    // next step's A fragment is loaded and split while the group runs, into
    // the registers that the group before last has finished reading.
    const float* ap = ring + ((u - lo) % stages) * kTiles * slot + a_off;
    const int ksteps = K8 / 8;
    float acc[1][NJ][4];
    uint32_t ahi[2][4], alo[2][4];
    auto load_a = [&](uint32_t(&h)[4], uint32_t(&l)[4], int ks) {
      uint32_t x[4];
      ldmatrix_x4(x, ap + 8 * ks);
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(__uint_as_float(x[e]), h[e], l[e]);
    };
    auto k_step = [&](const uint32_t(&h)[4], const uint32_t(&l)[4],
                      uint32_t(&h_next)[4], uint32_t(&l_next)[4], int ks) {
      const uint32_t at = bhi_addr + (ks >> 2) * (BW * 128) + (ks & 3) * 32;
      const uint64_t b_hi = swizzled_desc(at);
      const uint64_t b_lo = swizzled_desc(at + half_bytes);
      wgmma_fence();
      wgmma_tf32(acc[0], l, b_hi);
      wgmma_tf32(acc[0], h, b_lo);
      wgmma_tf32(acc[0], h, b_hi);
      wgmma_commit();
      wgmma_wait<1>();
      if (ks + 1 < ksteps) load_a(h_next, l_next, ks + 1);
    };
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;
    fence_acc(acc[0]);
    load_a(ahi[0], alo[0], 0);
    for (int ks = 0; ks < ksteps; ks += 2) {
      k_step(ahi[0], alo[0], ahi[1], alo[1], ks);
      if (ks + 1 < ksteps) k_step(ahi[1], alo[1], ahi[0], alo[0], ks + 1);
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    if (g < G)
      store_tile<PH, BW>(
          acc, out + (static_cast<size_t>(step) * G + g) * PH * BW, row0,
          col0);
    __syncthreads();  // every warp is done with this stage
    fill(u + stages);
  }
}

template <int PH, int BW, typename OutT>
__global__ void __launch_bounds__(Tiling<PH, BW>::THREADS)
    bsr_stream_kernel(const float* __restrict__ A_panels,
                      const float* __restrict__ Bt,
                      const int* __restrict__ tile_panel,
                      const int* __restrict__ step_cblock,
                      OutT* __restrict__ out, int G, int K, int N,
                      bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.x;
  const float* a = A_panels + static_cast<size_t>(tile_panel[t]) * PH * K;
  const long long base = static_cast<long long>(step_cblock[t / G]) * BW;
  auto b_row = [=](int c) -> const float* {
    const long long n = base + c;
    return n < N ? Bt + n * K : nullptr;
  };
  tile_mma_stream<PH, BW>(a, b_row, K, vec,
                          out + static_cast<size_t>(t) * PH * BW, smem, Bt);
}

template <int PH, int BW, typename OutT>
int launch(const float* a, const float* b, const int* tp, const int* sc,
           void* out, int T, int G, int K, int N, bool vec,
           cudaStream_t s) {
  using TL = Tiling<PH, BW>;
  constexpr int kTiles = kUnitRows / TL::PHP;
  OutT* o = static_cast<OutT*>(out);
  int stages = 3;
  if (resident_bytes(BW, K, stages) > kMaxSmem) stages = 2;
  const long long bytes = resident_bytes(BW, K, stages);
  cudaError_t err;
  int device = 0;
  if (G >= 2 && bytes <= kMaxSmem) {
    auto kern = bsr_resident_kernel<PH, BW, OutT>;
    static SmemLimit limit;
    err = limit.raise(kern, static_cast<int>(bytes), &device);
    if (err != cudaSuccess) return static_cast<int>(err);
    // blocks the device holds at once at this size, found once per device
    // and size
    static std::mutex mu;
    static long long sized_for[kMaxDevices] = {};
    static int held[kMaxDevices] = {};
    int resident_blocks;
    {
      std::lock_guard<std::mutex> lock(mu);
      if (sized_for[device] != bytes) {
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
        if (err == cudaSuccess)
          err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, kern, kBlockThreads, static_cast<size_t>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
        if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
        held[device] = sms * per_sm;
        sized_for[device] = bytes;
      }
      resident_blocks = held[device];
    }
    const long long units =
        static_cast<long long>(T / G) * ((G + kTiles - 1) / kTiles);
    const int grid = static_cast<int>(
        units < resident_blocks ? units : resident_blocks);
    kern<<<grid, kBlockThreads, bytes, s>>>(a, b, tp, sc, o, T, G, K, N,
                                            stages, vec);
  } else {
    auto kern = bsr_stream_kernel<PH, BW, OutT>;
    const int smem = stream_smem_bytes<PH, BW>(K);
    static SmemLimit limit;
    err = limit.raise(kern, smem, &device);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<T, TL::THREADS, smem, s>>>(a, b, tp, sc, o, G, K, N, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bsmr_bsr_dense(const void* A_panels, const void* Bt,
                              const void* tile_panel, const void* step_cblock,
                              void* out, int T, int G, int ph, int bw, int K,
                              int N, int out_f16, void* stream) {
  if (T <= 0 || G <= 0 || K <= 0 || T % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A_panels);
  const float* b = static_cast<const float*>(Bt);
  const int* tp = static_cast<const int*>(tile_panel);
  const int* sc = static_cast<const int*>(step_cblock);
  const bool vec = vector_path(a, b, K);
#define BSMR_LAUNCH(PH, BW)                                                  \
  if (ph == PH && bw == BW)                                                  \
    return out_f16 ? launch<PH, BW, __half>(a, b, tp, sc, out, T, G, K, N,   \
                                            vec, s)                          \
                   : launch<PH, BW, float>(a, b, tp, sc, out, T, G, K, N,    \
                                           vec, s);
  BSMR_MMA_FOR_EACH_GEOMETRY(BSMR_LAUNCH)
#undef BSMR_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
