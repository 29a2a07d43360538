// segment_cmp: per-segment max or min of an integer column; segment
// ids outside [0, k) drop. The output holds the data dtype's identity
// (its min for max, its max for min) on entry, widened to int64, so an
// empty segment keeps it.
//
// Replaces: _cmp_pallas (presto_tpu/kernels/segagg.py:118), behind
// segment_max_pallas and segment_min_pallas: the TPU kernel walks
// 256-row tiles in a sequential grid and compares two uint32 limbs
// with a biased sign bit (the TPU has no 64-bit ALU).
//
// Bound on this card: bytes. Each row is read once (the value, widened
// in registers, and a 4-byte segment id) and does one 64-bit compare,
// far below the integer rate, so the floor is
// (n * (sizeof(T) + 4) + k * 8) / 3.35 TB/s.
//
// Design: Hopper has native 64-bit atomicMax/atomicMin on long long in
// global and shared memory, so the limb planes go. Max and min are
// order-free, so any order of atomics gives the reference's bits.
// Values widen to int64 (signed types sign-extend, uint8
// zero-extends; both keep the order). k = 1 (a global max, Q15)
// reduces in registers and across the warp with shuffles, so one
// atomic per warp reaches the single address. While k fits in shared
// memory, each block keeps per-segment partials there and flushes
// each one that moved with one global atomic; past that, rows go to
// the output with global atomics directly.
#include <limits>

#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ long long widen(T v) {
  return static_cast<long long>(v);
}

template <bool kMax>
__device__ __forceinline__ long long better(long long a, long long b) {
  return kMax ? (a > b ? a : b) : (a < b ? a : b);
}

template <bool kMax>
__device__ __forceinline__ void atomic_better(long long* p, long long v) {
  if (kMax) {
    atomicMax(p, v);
  } else {
    atomicMin(p, v);
  }
}

template <typename T, bool kMax>
__global__ void seg_cmp_one(const T* __restrict__ data,
                            const int* __restrict__ seg, long long n,
                            long long ident, long long* __restrict__ out) {
  long long acc = ident;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    if (seg[i] == 0) acc = better<kMax>(acc, widen<T>(data[i]));
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc = better<kMax>(acc, __shfl_down_sync(0xFFFFFFFFu, acc, off));
  }
  if ((threadIdx.x & 31) == 0 && acc != ident) atomic_better<kMax>(out, acc);
}

template <typename T, bool kMax>
__global__ void seg_cmp_shared(const T* __restrict__ data,
                               const int* __restrict__ seg, long long n,
                               int k, long long ident,
                               long long* __restrict__ out) {
  extern __shared__ long long part[];
  for (int s = threadIdx.x; s < k; s += blockDim.x) part[s] = ident;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int s = seg[i];
    if (s >= 0 && s < k) atomic_better<kMax>(&part[s], widen<T>(data[i]));
  }
  __syncthreads();
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    const long long v = part[s];
    if (v != ident) atomic_better<kMax>(&out[s], v);
  }
}

template <typename T, bool kMax>
__global__ void seg_cmp_global(const T* __restrict__ data,
                               const int* __restrict__ seg, long long n,
                               int k, long long* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int s = seg[i];
    if (s >= 0 && s < k) atomic_better<kMax>(&out[s], widen<T>(data[i]));
  }
}

constexpr int kThreads = 256;
// 6144 partials * 8 B = 48 KB: the dynamic shared memory a block gets
// without an opt-in attribute (as in segment_sum.cu)
constexpr int kSharedMaxK = 6144;

template <typename T, bool kMax>
void launch(const void* data, const int* seg, long long n, int k,
            long long* out, cudaStream_t stream) {
  const T* d = static_cast<const T*>(data);
  // the identity the wrapper filled the output with
  const long long ident =
      kMax ? static_cast<long long>(std::numeric_limits<T>::min())
           : static_cast<long long>(std::numeric_limits<T>::max());
  if (k == 1) {
    const int blocks = pt::grid_for(n, kThreads * 16, 132 * 4);
    seg_cmp_one<T, kMax><<<blocks, kThreads, 0, stream>>>(d, seg, n, ident,
                                                          out);
  } else if (k <= kSharedMaxK) {
    const int blocks = pt::grid_for(n, kThreads * 16, 132 * 4);
    seg_cmp_shared<T, kMax><<<blocks, kThreads, k * sizeof(long long),
                              stream>>>(d, seg, n, k, ident, out);
  } else {
    const int blocks = pt::grid_for(n, kThreads, 132 * 32);
    seg_cmp_global<T, kMax><<<blocks, kThreads, 0, stream>>>(d, seg, n, k,
                                                             out);
  }
}

template <bool kMax>
int dispatch(const void* data, int dtype, const int* seg, long long n, int k,
             long long* out, cudaStream_t s) {
  switch (dtype) {
    case 1: launch<uint8_t, kMax>(data, seg, n, k, out, s); break;
    case 2: launch<int8_t, kMax>(data, seg, n, k, out, s); break;
    case 3: launch<int16_t, kMax>(data, seg, n, k, out, s); break;
    case 4: launch<int32_t, kMax>(data, seg, n, k, out, s); break;
    case 5: launch<int64_t, kMax>(data, seg, n, k, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes as pt_segment_sum's (bool excluded): 1 uint8, 2 int8,
// 3 int16, 4 int32, 5 int64. ``out`` holds k copies of the dtype's
// identity (widened to int64) on entry. Returns cudaGetLastError().
extern "C" int pt_segment_cmp(const void* data, int dtype, const int* seg,
                              long long n, int k, int is_max,
                              long long* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_max ? dispatch<true>(data, dtype, seg, n, k, out, s)
                : dispatch<false>(data, dtype, seg, n, k, out, s);
}
