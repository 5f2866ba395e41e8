// CSR emission of the SDDMM body: the (nnz,) values in CSR order, each copied
// straight from the tier array that computed it,
//
//   out[i] = slots[rphm_to_csr[i]],
//   slots  = dense ++ packed ++ gathered ++ residual  (every padded slot of
//            the four tiers, flattened, in that order),
//
// without ever building `slots`. It replaces no Pallas kernel: the JAX body
// joins the four tiers with jnp.concatenate and takes along rphm_to_csr
// (bsmr_sddmm_tpu/ops/sddmm.py:569-573). As torch.cat, that join copies
// every padded slot, 13 to 36 times the nonzeros on SuiteSparse masks
// (ph = 32, bw = 128), written and read again before the gather; this kernel
// reads only the slots that hold a nonzero.
//
// What bounds it: bytes. Per nonzero, 4 bytes of index read and one value
// written (4 or 2 bytes), plus the 32-byte sector that holds the value read.
// Consecutive values of a CSR row mostly lie in one row of one tile, so
// neighbours share sectors. The design: each thread takes kVec = 4
// consecutive nonzeros (one 16-byte load of their indices, four loads through
// the read-only path, one 16-byte store for fp32 or 8-byte store for fp16),
// so a warp's index loads and stores cover 128 consecutive nonzeros and
// coalesce. The tier of slot j is found by comparing j with the three running
// slot offsets; an empty tier has no slots, so no j selects it and its
// pointer is never read. The copy moves bits and does no arithmetic: the
// element is an unsigned integer of the value's size (4 bytes: fp32; 2
// bytes: fp16, bf16), so every output type is copied exactly. Where nnz % 4
// != 0 the last thread copies its values one at a time; where the index or
// the output pointer is not aligned for vectors, every thread does.
//
// Slot offsets are int32, as rphm_to_csr is: the four tiers together hold
// fewer than 2^31 slots (checked here and by the wrapper). Indices are the
// plan's own (pack.pack_tiles), each below that total. Plain C interface for
// ctypes; returns the first CUDA error of the launch.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

template <typename T>
struct Tiers {
  const T* dense;
  const T* packed;
  const T* gathered;
  const T* residual;
  int end_dense, end_packed, end_gathered;  // running slot offsets
};

// kVec elements of T as one store: 16 bytes of fp32, 8 of fp16.
template <typename T>
struct VecOf;
template <>
struct VecOf<uint32_t> {
  using type = uint4;
};
template <>
struct VecOf<uint16_t> {
  using type = uint2;
};

template <typename T>
__device__ __forceinline__ T slot(const Tiers<T>& t, int j) {
  const T* base = t.dense;
  int off = 0;
  if (j >= t.end_dense) {
    base = t.packed;
    off = t.end_dense;
  }
  if (j >= t.end_packed) {
    base = t.gathered;
    off = t.end_packed;
  }
  if (j >= t.end_gathered) {
    base = t.residual;
    off = t.end_gathered;
  }
  return __ldg(base + (j - off));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    csr_emit_kernel(const Tiers<T> tiers, const int* __restrict__ rphm_to_csr,
                    T* __restrict__ out, int nnz, bool vec) {
  using V = typename VecOf<T>::type;
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (i0 >= nnz) return;
  if (vec && i0 + kVec <= nnz) {
    const int4 j = __ldg(reinterpret_cast<const int4*>(rphm_to_csr + i0));
    alignas(sizeof(V)) T v[kVec] = {slot(tiers, j.x), slot(tiers, j.y),
                                    slot(tiers, j.z), slot(tiers, j.w)};
    *reinterpret_cast<V*>(out + i0) = *reinterpret_cast<const V*>(v);
    return;
  }
  const int64_t end = i0 + kVec < nnz ? i0 + kVec : nnz;
  for (int64_t i = i0; i < end; ++i)
    out[i] = slot(tiers, __ldg(rphm_to_csr + i));
}

template <typename T>
int launch(const void* const* tier, const int* count, const int* idx,
           void* out, int nnz, cudaStream_t s) {
  Tiers<T> t;
  t.dense = static_cast<const T*>(tier[0]);
  t.packed = static_cast<const T*>(tier[1]);
  t.gathered = static_cast<const T*>(tier[2]);
  t.residual = static_cast<const T*>(tier[3]);
  t.end_dense = count[0];
  t.end_packed = t.end_dense + count[1];
  t.end_gathered = t.end_packed + count[2];
  const bool vec =
      reinterpret_cast<uintptr_t>(idx) % sizeof(int4) == 0 &&
      reinterpret_cast<uintptr_t>(out) % sizeof(typename VecOf<T>::type) == 0;
  const int64_t threads = (static_cast<int64_t>(nnz) + kVec - 1) / kVec;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  csr_emit_kernel<T><<<blocks, kThreads, 0, s>>>(t, idx, static_cast<T*>(out),
                                                 nnz, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dense, packed, gathered, residual: the tiers' base pointers (any value for
// a tier of 0 slots); n_*: their slot counts; elem_size: 4 or 2 bytes.
extern "C" int bsmr_csr_emit(const void* dense, const void* packed,
                             const void* gathered, const void* residual,
                             int n_dense, int n_packed, int n_gathered,
                             int n_residual, const void* rphm_to_csr,
                             void* out, int nnz, int elem_size,
                             void* stream) {
  const int64_t total = static_cast<int64_t>(n_dense) + n_packed +
                        n_gathered + n_residual;
  if (nnz <= 0 || n_dense < 0 || n_packed < 0 || n_gathered < 0 ||
      n_residual < 0 || total > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* tier[4] = {dense, packed, gathered, residual};
  const int count[3] = {n_dense, n_packed, n_gathered};
  const int* idx = static_cast<const int*>(rphm_to_csr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4) return launch<uint32_t>(tier, count, idx, out, nnz, s);
  if (elem_size == 2) return launch<uint16_t>(tier, count, idx, out, nnz, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
