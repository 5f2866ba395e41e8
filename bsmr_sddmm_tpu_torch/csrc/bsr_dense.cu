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
// operations (in three passes; 2^20 in one) for 16 KB of output, and the
// operands are shared between tiles, so at three passes bytes (the output
// store) and tensor-core operations bind within a few percent of each other;
// at one pass, and at K = 32, the output store binds alone. The design
// keeps everything but the output store out of the way of the MMAs:
//
// * Resident route (G >= 2 and the block fits), on warpgroup MMAs
//   (tile_wgmma.cuh): the work is the list of units (fat step, 64 rows of
//   it: 2 tiles of 32 rows, 1 of 64, 4 of 16 or 8), in order, and each of
//   the persistent thread blocks (as many as the card holds at once) walks
//   one contiguous share of it. The step's column block (BW x K) is copied
//   into shared memory when the block reaches a new step, split once into
//   TF32 hi (in place) and lo (a second buffer; at one pass rounded to hi
//   alone, the second buffer left unused), and reused for every unit
//   of that step: the tensor cores read it from shared memory without any
//   conversion, and a column block is read from L2 two or three times per
//   thread block, not once per tile. The A panels (PH x K, contiguous)
//   stream through a ring of 2 or 3 stages (a unit each) filled by cp.async
//   under the MMAs of the units before, across step boundaries too; each of
//   the block's two warpgroups multiplies the unit's 64 rows, split into hi
//   and lo (or rounded) in registers, by one half of the block's columns.
//   Shared memory: 2 * BW * K32 * 4 bytes (K32 = K rounded up to 32) plus
//   stages * 64 * (K8 + 4) * 4 (K8 = K rounded up to 8): 195 KB at
//   (32, 128, 128) with 2 stages, one block per SM; 60 KB at K = 32 with 3
//   stages, three blocks per SM.
// * Sliced resident route (G >= 2, the block too large, 64-column slices
//   of it small enough), on warpgroup MMAs: the column block is cut into
//   BW / 64 slices of 64 columns, and the work is the list of units (fat
//   step, slice, 64 rows of the step), ordered by step, then slice, then
//   rows, so that a persistent block, walking one contiguous share of it
//   two units at a time (one a warpgroup, both in the same slice), copies
//   and splits a slice (64 x K, hi and lo) only when the step or the slice
//   changes, and then sends the next slice of its share toward L2. Each
//   warpgroup multiplies its unit's 64 rows by all 64 columns of the slice
//   (m64n64k8), three MMAs a step of 8 at three passes, one at one pass,
//   as the resident route does, two steps (a fragment set each, split in
//   registers) to a group. Each warpgroup streams its unit's A rows
//   through its half of a ring of 2 to 6 stages of 32 K-columns (as many
//   as fit), filled by cp.async under the MMAs of the stages before and
//   guarded by a barrier of its own 128 threads, so that one warpgroup's
//   copies, barriers and stores run beside the other's MMAs; the two meet
//   only where the slice changes. A is read once per slice. Every chunk is
//   a whole slab of 32 (zeros past K), and no branch that depends on the
//   thread runs while MMAs are in flight: the compiler serializes every
//   MMA otherwise (ptxas C7518 / C7513 in the build's report).
//   Shared memory: 2 * 64 * K32 * 4 bytes plus stages * 2 * 64 * (32 + 4)
//   * 4, plus 1024 of alignment: 219 KB at K = 256 with 5 stages, one
//   block per SM. Bound: the slice must fit beside 2 stages,
//   512 * K32 <= kMaxSmem - 1024 - 36864, so K32 <= 352, K <= 352 at
//   either width; 6 stages up to K = 224. The route takes K above 128 at
//   BW = 128 and above 64 at BW = 256 (the resident route's limits) up to
//   352. At (32, 128, 256) the column block is read from L2 and split once
//   per step and slice instead of once per tile: 50 MB instead of 805 MB
//   a call on pdb1HYS's plan (6 144 tiles, G = 16), A 402 MB instead of
//   201 (once per slice). There, on random operands, it takes 0.248 ms
//   against the streaming route's 0.325 at three passes and 0.198 against
//   0.210 at one (H100; PERF.md).
// * Streaming route (G = 1, or K above 352), on mma.sync (tile_mma.cuh):
//   one tile per thread block of 4 warps (8 for 64-row panels), both
//   operands walked in K-chunks of 32 through a 2-stage cp.async ring and
//   split on the fly (tile_mma_stream); 45 KB at (32, 128), four blocks
//   per SM. At G = 1 a column block serves one tile, so there is nothing
//   to keep.
//
// The route is a function of (G, BW, K) alone (bsr_route; its Python
// twin is ops/dense_kernels.py's bsr_route, and bsmr_bsr_dense_route
// gives the library's answer for tests).
//
// Measured on an H100 (PERF.md): at K = 128 the resident route's MMA loop
// alone takes about 0.13 of its 0.18 ms, and the copies and the stores add
// to that instead of hiding under it (one block per SM, both warpgroups in
// step). Warp-specialised producers and TMA loads are the next step.
//
// Every route takes any K: where K % 4 != 0 (or an operand is not 16-byte
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

template <int PH, int BW, int PASSES, typename OutT>
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
      // split the resident block once: hi in place, lo beside it (at one
      // pass hi alone)
      for (int o = 4 * threadIdx.x; o < BW * K32; o += 4 * kBlockThreads) {
        const float4 x = *reinterpret_cast<const float4*>(Bhi + o);
        uint4 h, l;
        if constexpr (PASSES == 3) {
          tf32_split(x.x, h.x, l.x);
          tf32_split(x.y, h.y, l.y);
          tf32_split(x.z, h.z, l.z);
          tf32_split(x.w, h.w, l.w);
          *reinterpret_cast<uint4*>(Blo + o) = l;
        } else {
          h = make_uint4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                         tf32_rna(x.w));
        }
        *reinterpret_cast<uint4*>(Bhi + o) = h;
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
    // one group (a_lo.b_hi, a_hi.b_lo, a_hi.b_hi: small terms first), or
    // a_hi.b_hi alone at one pass; the next step's A fragment is loaded and
    // split while the group runs, into the registers that the group before
    // last has finished reading.
    const float* ap = ring + ((u - lo) % stages) * kTiles * slot + a_off;
    const int ksteps = K8 / 8;
    float acc[1][NJ][4];
    uint32_t ahi[2][4], alo[2][4];
    auto load_a = [&](uint32_t(&h)[4], uint32_t(&l)[4], int ks) {
      uint32_t x[4];
      ldmatrix_x4(x, ap + 8 * ks);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (PASSES == 3)
          tf32_split(__uint_as_float(x[e]), h[e], l[e]);
        else
          h[e] = tf32_rna(__uint_as_float(x[e]));
      }
    };
    auto k_step = [&](const uint32_t(&h)[4], const uint32_t(&l)[4],
                      uint32_t(&h_next)[4], uint32_t(&l_next)[4], int ks) {
      const uint32_t at = bhi_addr + (ks >> 2) * (BW * 128) + (ks & 3) * 32;
      const uint64_t b_hi = swizzled_desc(at);
      wgmma_fence();
      if constexpr (PASSES == 3) {
        wgmma_tf32(acc[0], l, b_hi);
        wgmma_tf32(acc[0], h, swizzled_desc(at + half_bytes));
      }
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

constexpr int kSliceCols = 64;  // columns of a slice: one n64 MMA
constexpr int kSliceChunk = 32;  // K-columns of A in a ring stage
constexpr int kSliceUnits = 2;   // units a block works at once, one a warpgroup
constexpr int kSliceStages = 6;  // ring stages at most
constexpr int kWarpgroupThreads = 128;  // 4 warps: one MMA's

// Shared memory of the sliced route at depth K with `stages` ring stages:
// one slice in both halves (swizzled slabs after up to 1024 bytes of
// alignment) and the stages' padded rows of both units.
inline long long sliced_bytes(int K, int stages) {
  const int K32 = (K + kSlabK - 1) / kSlabK * kSlabK;
  return 1024 + static_cast<long long>(sizeof(float)) *
                    (2LL * kSliceCols * K32 +
                     static_cast<long long>(stages) * kSliceUnits *
                         kUnitRows * (kSliceChunk + kPadK));
}

enum Route { kRouteResident = 0, kRouteSliced = 1, kRouteStream = 2 };

// The route launch() takes for a fat group G, block width bw and depth K,
// and its ring stages: resident where the whole column block fits beside a
// ring of 2 units (3 where they fit), sliced where G >= 2 and a slice fits
// beside 2 stages (as many as fit, up to kSliceStages), streaming
// otherwise.
inline Route bsr_route(int G, int bw, int K, int* stages) {
  *stages = resident_bytes(bw, K, 3) <= kMaxSmem ? 3 : 2;
  if (G >= 2 && resident_bytes(bw, K, *stages) <= kMaxSmem)
    return kRouteResident;
  *stages = 2;
  while (*stages < kSliceStages && sliced_bytes(K, *stages + 1) <= kMaxSmem)
    ++*stages;
  if (G >= 2 && sliced_bytes(K, 2) <= kMaxSmem) return kRouteSliced;
  *stages = kStreamStages;
  return kRouteStream;
}

// Waits until at most n (< kSliceStages) of this thread's newest cp.async
// groups are pending.
__device__ __forceinline__ void cp_async_wait_for(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    default: cp_async_wait<kSliceStages - 1>(); break;
  }
}

template <int PH, int BW, int PASSES, typename OutT>
__global__ void __launch_bounds__(kBlockThreads)
    bsr_sliced_kernel(const float* __restrict__ A_panels,
                      const float* __restrict__ Bt,
                      const int* __restrict__ tile_panel,
                      const int* __restrict__ step_cblock,
                      OutT* __restrict__ out, int T, int G, int K, int N,
                      int stages, bool vec) {
  using TL = Tiling<PH, BW>;
  constexpr int kTiles = kUnitRows / TL::PHP;  // tiles of a unit
  constexpr int kSlices = BW / kSliceCols;
  constexpr int SA = kSliceChunk + kPadK;      // floats of a ring row
  constexpr int kUnit = kUnitRows * SA;        // floats of a unit's stage
  constexpr int kStage = kSliceUnits * kUnit;
  extern __shared__ __align__(16) unsigned char raw[];
  const int K32 = (K + kSlabK - 1) / kSlabK * kSlabK;
  const uint32_t raw_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  float* Bhi =  // on a 1024-byte boundary, as the swizzle needs
      reinterpret_cast<float*>(raw + (1024 - raw_addr % 1024) % 1024);
  float* Blo = Bhi + kSliceCols * K32;
  float* ring = Blo + kSliceCols * K32;

  // this block's share [lo, hi) of the items: an item is two units of one
  // (step, slice), the second absent where the step has an odd count
  const int per_step = (G + kTiles - 1) / kTiles;
  const int pairs = (per_step + 1) / 2;
  const long long items = static_cast<long long>(T / G) * kSlices * pairs;
  const int lo = static_cast<int>(items * blockIdx.x / gridDim.x);
  const int hi = static_cast<int>(items * (blockIdx.x + 1) / gridDim.x);
  // every chunk is a whole slab of 32 along K (the slice and the stages
  // hold zeros past K), so that each runs the same 4 steps of 8
  const int chunks = K32 / kSliceChunk;
  const int fills = (hi - lo) * chunks;  // ring stages this block fills

  // warpgroup wg takes unit wg of each item and runs its own ring: it
  // fills that unit's rows of each stage and waits only for its own 128
  // threads (a named barrier), so that one warpgroup's barriers, copies
  // and stores run beside the other's MMAs; the two meet where the slice
  // changes. Warp w of it multiplies rows 16w .. 16w+15 of the unit, rows
  // row0 .. of its tile number `tile`.
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int w = warp & 3;
  const int lt = threadIdx.x & (kWarpgroupThreads - 1);
  const int tile = (16 * w) / TL::PHP;
  const int row0 = (16 * w) % TL::PHP;
  const int lane = threadIdx.x & 31;
  auto wg_sync = [&] {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kWarpgroupThreads)
                 : "memory");
  };

  // the panel ids of the tiles of the warpgroup's unit of an item (-1
  // past G); those of the item after the one being filled are loaded when
  // its first stage is filled, so that no fill waits for them
  auto panels_of = [&](int i, int (&ids)[kTiles]) {
    const int step = i / pairs / kSlices;
    const int first = ((i % pairs) * kSliceUnits + wg) * kTiles;
#pragma unroll
    for (int p = 0; p < kTiles; ++p)
      ids[p] = i < hi && first + p < G
                   ? __ldg(tile_panel + step * G + first + p)
                   : -1;
  };
  int filling = lo, ids[kTiles], next_ids[kTiles];
  panels_of(lo, ids);
  panels_of(lo + 1, next_ids);

  // copies chunk q % chunks of the warpgroup's unit of item lo + q /
  // chunks into stage q % stages, one group per call. Every thread makes
  // the same count of copies, zero-filling rows past PH, tiles past G and
  // columns past K, so that no branch depends on the thread while MMAs run
  // (the compiler would serialize them).
  auto fill_by = [&](auto vec_tag, float* dst, int k0) {
    constexpr int VEC = decltype(vec_tag)::value;
    constexpr int kPer = kSliceChunk / VEC;  // copies of a row
#pragma unroll
    for (int it = 0; it < kUnitRows * kPer / kWarpgroupThreads; ++it) {
      const int slot = it * kWarpgroupThreads + lt;
      const int row = slot / kPer;  // of the unit's 64
      const int col = (slot % kPer) * VEC;
      const int r = row % TL::PHP;
      const int p = row / TL::PHP;  // tile of the unit
      int id = -1;
#pragma unroll
      for (int j = 0; j < kTiles; ++j) id = j == p ? ids[j] : id;
      const bool ok = r < PH && id >= 0 && k0 + col < K;
      cp_async<VEC * 4>(
          dst + row * SA + col,
          ok ? A_panels + (static_cast<size_t>(id) * PH + r) * K + k0 + col
             : Bt,
          ok);
    }
  };
  auto fill = [&](int q) {
    if (q < fills) {
      const int i = lo + q / chunks;
      if (i != filling) {  // the next item: q steps through them in order
        filling = i;
#pragma unroll
        for (int p = 0; p < kTiles; ++p) ids[p] = next_ids[p];
        panels_of(i + 1, next_ids);
      }
      const int k0 = (q % chunks) * kSliceChunk;
      float* dst = ring + (q % stages) * kStage + wg * kUnit;
      if (vec)
        fill_by(std::integral_constant<int, 4>(), dst, k0);
      else
        fill_by(std::integral_constant<int, 1>(), dst, k0);
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) fill(s);

  const int a_off = wg * kUnit +
                    (16 * w + (lane & 7) + ((lane >> 3) & 1) * 8) * SA +
                    (lane >> 4) * 4;  // the lane's ldmatrix row and column
  const uint32_t bhi_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(Bhi));
  const uint32_t half_bytes = static_cast<uint32_t>(kSliceCols) * K32 * 4;
  auto slice_base = [&](int group) {  // first row of Bt of a (step, slice)
    return static_cast<long long>(step_cblock[group / kSlices]) * BW +
           (group % kSlices) * kSliceCols;
  };

  float acc[1][8][4];
  uint32_t ahi[4][4], alo[4][4];  // A fragments, a set a step of a chunk
  int resident = -1;  // the (step, slice) whose slice is in Bhi / Blo
  int q = 0;
  for (int i = lo; i < hi; ++i) {
    const int group = i / pairs;  // step * kSlices + slice
    const int step = group / kSlices;
    const int slice = group % kSlices;
    const int unit = (i % pairs) * kSliceUnits + wg;
    const int g = unit * kTiles + tile;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;
    fence_acc(acc[0]);
    if (group != resident) {
      resident = group;
      __syncthreads();  // every warp is done with the slice before
      const long long base = slice_base(group);
      stage_swizzled<kBlockThreads>(vec, threadIdx.x, Bhi, kSliceCols, K32,
                                    K,
                                    [=](int n) -> const float* {
                                      const long long col = base + n;
                                      return col < N ? Bt + col * K
                                                     : nullptr;
                                    },
                                    Bt);
      cp_async_commit();
      // the next slice of this block's share, on its way to L2 while this
      // one is worked
      const int next = (group + 1) * pairs;
      if (next < hi) {
        const long long nb = slice_base(group + 1);
        for (int e = threadIdx.x; e < kSliceCols * (K32 / 32);
             e += kBlockThreads) {
          const long long col = nb + e / (K32 / 32);
          if (col < N)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(
                Bt + col * K + (e % (K32 / 32)) * 32));
        }
      }
      cp_async_wait<0>();
      __syncthreads();
      // split the slice once: hi in place, lo beside it (at one pass hi
      // alone)
      for (int o = 4 * threadIdx.x; o < kSliceCols * K32;
           o += 4 * kBlockThreads) {
        const float4 x = *reinterpret_cast<const float4*>(Bhi + o);
        uint4 h, l;
        if constexpr (PASSES == 3) {
          tf32_split(x.x, h.x, l.x);
          tf32_split(x.y, h.y, l.y);
          tf32_split(x.z, h.z, l.z);
          tf32_split(x.w, h.w, l.w);
          *reinterpret_cast<uint4*>(Blo + o) = l;
        } else {
          h = make_uint4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                         tf32_rna(x.w));
        }
        *reinterpret_cast<uint4*>(Bhi + o) = h;
      }
      fence_proxy_async();
      __syncthreads();
    }
    for (int c = 0; c < chunks; ++c, ++q) {
      // one group is committed per stage filled, so all but the newest
      // stages - 2 groups being complete means stage q has landed; after
      // the barrier every warp of the warpgroup is done with stage q - 1,
      // which is filled
      cp_async_wait_for(stages - 2);
      wg_sync();
      fill(q + stages - 1);
      {
        // this warpgroup's 64 x 64 sums over the chunk's 4 steps of 8 along
        // K, as the resident route: three MMAs a step (one at one pass), a
        // group of two steps at a time. Each step has its own set of A
        // fragments, loaded and split in registers two at a time while
        // the group before runs: the first two sets once the group before
        // last (the previous chunk's first) has finished reading them, the
        // last two once the previous chunk's second group has.
        static_assert(kSliceChunk == 32, "4 steps of 8 a chunk");
        const float* ap = ring + (q % stages) * kStage + a_off;
        auto load_a = [&](int ks) {
          uint32_t x[4];
          ldmatrix_x4(x, ap + 8 * ks);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (PASSES == 3)
              tf32_split(__uint_as_float(x[e]), ahi[ks][e], alo[ks][e]);
            else
              ahi[ks][e] = tf32_rna(__uint_as_float(x[e]));
          }
        };
        auto k_step = [&](int ks) {
          const uint32_t at = bhi_addr + c * (kSliceCols * 128) + ks * 32;
          const uint64_t b_hi = swizzled_desc(at);
          if constexpr (PASSES == 3) {
            wgmma_tf32(acc[0], alo[ks], b_hi);
            wgmma_tf32(acc[0], ahi[ks], swizzled_desc(at + half_bytes));
          }
          wgmma_tf32(acc[0], ahi[ks], b_hi);
        };
#pragma unroll
        for (int ks = 0; ks < 4; ks += 2) {
          load_a(ks);
          load_a(ks + 1);
          wgmma_fence();
          k_step(ks);
          k_step(ks + 1);
          wgmma_commit();
          wgmma_wait<1>();
        }
      }
    }
    // the sums are read only after the last MMA: a branch that depends on
    // the thread and reads them while MMAs may run would make the compiler
    // serialize every MMA
    wgmma_wait<0>();
    fence_acc(acc[0]);
    if (g < G)
      store_tile<PH, BW>(
          acc, out + (static_cast<size_t>(step) * G + g) * PH * BW, row0,
          slice * kSliceCols);
  }
}

template <int PH, int BW, int PASSES, typename OutT>
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
  tile_mma_stream<PH, BW, PASSES>(a, b_row, K, vec,
                                  out + static_cast<size_t>(t) * PH * BW,
                                  smem, Bt);
}

// Thread blocks of kBlockThreads the device holds at once for a kernel at
// `bytes` of shared memory, found once per device and size. One object per
// instantiation: a static of its launch branch.
struct BlocksHeld {
  std::mutex mu;
  long long sized_for[kMaxDevices] = {};
  int held[kMaxDevices] = {};

  template <typename Kern>
  cudaError_t get(Kern kern, long long bytes, int device, int* blocks) {
    std::lock_guard<std::mutex> lock(mu);
    if (sized_for[device] != bytes) {
      int sms = 0, per_sm = 0;
      cudaError_t err = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, device);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kern, kBlockThreads, static_cast<size_t>(bytes));
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidValue;
      held[device] = sms * per_sm;
      sized_for[device] = bytes;
    }
    *blocks = held[device];
    return cudaSuccess;
  }
};

template <int PH, int BW, int PASSES, typename OutT>
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
    auto kern = bsr_resident_kernel<PH, BW, PASSES, OutT>;
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
  } else if (bsr_route(G, BW, K, &stages) == kRouteSliced) {
    auto kern = bsr_sliced_kernel<PH, BW, PASSES, OutT>;
    const long long sbytes = sliced_bytes(K, stages);
    static SmemLimit limit;
    err = limit.raise(kern, static_cast<int>(sbytes), &device);
    if (err != cudaSuccess) return static_cast<int>(err);
    static BlocksHeld held;
    int resident_blocks;
    err = held.get(kern, sbytes, device, &resident_blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int per_step = (G + kTiles - 1) / kTiles;
    const long long items = static_cast<long long>(T / G) *
                            (BW / kSliceCols) * ((per_step + 1) / 2);
    const int grid = static_cast<int>(
        items < resident_blocks ? items : resident_blocks);
    kern<<<grid, kBlockThreads, sbytes, s>>>(a, b, tp, sc, o, T, G, K, N,
                                             stages, vec);
  } else {
    auto kern = bsr_stream_kernel<PH, BW, PASSES, OutT>;
    const int smem = stream_smem_bytes<PH, BW>(K);
    static SmemLimit limit;
    err = limit.raise(kern, smem, &device);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<T, TL::THREADS, smem, s>>>(a, b, tp, sc, o, G, K, N, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The route bsmr_bsr_dense takes for (G, ph, bw, K): 0 resident, 1 sliced,
// 2 streaming, -1 for a tile geometry it has no kernel for; *smem gets the
// dynamic shared memory the launch asks for.
extern "C" int bsmr_bsr_dense_route(int G, int ph, int bw, int K,
                                    long long* smem) {
  if (G <= 0 || K <= 0) return -1;
  int stages;
  const Route route = bsr_route(G, bw, K, &stages);
#define BSMR_ROUTE(PH, BW)                                                   \
  if (ph == PH && bw == BW) {                                                \
    *smem = route == kRouteResident ? resident_bytes(BW, K, stages)          \
            : route == kRouteSliced ? sliced_bytes(K, stages)                \
                                    : stream_smem_bytes<PH, BW>(K);          \
    return route;                                                            \
  }
  BSMR_MMA_FOR_EACH_GEOMETRY(BSMR_ROUTE)
#undef BSMR_ROUTE
  return -1;
}

// passes: 3 or 1 TF32 passes (tile_mma.cuh, numerics).
extern "C" int bsmr_bsr_dense(const void* A_panels, const void* Bt,
                              const void* tile_panel, const void* step_cblock,
                              void* out, int T, int G, int ph, int bw, int K,
                              int N, int out_f16, int passes, void* stream) {
  if (T <= 0 || G <= 0 || K <= 0 || T % G != 0 ||
      (passes != 1 && passes != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A_panels);
  const float* b = static_cast<const float*>(Bt);
  const int* tp = static_cast<const int*>(tile_panel);
  const int* sc = static_cast<const int*>(step_cblock);
  const bool vec = vector_path(a, b, K);
#define BSMR_LAUNCH_AT(PH, BW, P)                                            \
  return out_f16 ? launch<PH, BW, P, __half>(a, b, tp, sc, out, T, G, K, N,  \
                                             vec, s)                         \
                 : launch<PH, BW, P, float>(a, b, tp, sc, out, T, G, K, N,   \
                                            vec, s);
#define BSMR_LAUNCH(PH, BW)                                                  \
  if (ph == PH && bw == BW) {                                                \
    if (passes == 1) BSMR_LAUNCH_AT(PH, BW, 1)                               \
    BSMR_LAUNCH_AT(PH, BW, 3)                                                \
  }
  BSMR_MMA_FOR_EACH_GEOMETRY(BSMR_LAUNCH)
#undef BSMR_LAUNCH
#undef BSMR_LAUNCH_AT
  return static_cast<int>(cudaErrorInvalidValue);
}
