// segment_sum: per-segment sum of an integer or bool column, wrapping
// mod 2^64; segment ids outside [0, k) drop.
//
// Replaces: segment_sum_pallas (presto_tpu/kernels/segagg.py:68), the
// TPU kernel that walks 256-row tiles sequentially and carries two
// uint32 accumulator planes in VMEM (the TPU has no 64-bit ALU).
//
// Bound on this card: bytes. Each row is read once (data + a 4-byte
// segment id) and does one 64-bit add, far below the integer rate, so
// the floor is (n * (sizeof(T) + 4) + k * 8) / 3.35 TB/s.
//
// Design: Hopper has native 64-bit atomics, so the limb planes go.
// Integer addition mod 2^64 is order-free, so the result is
// bit-identical to the reference in any accumulation order. While k
// fits in shared memory, each block accumulates partials there (Q1 has
// six groups: sixty million global atomics on six addresses would
// serialise) and then adds each nonzero partial to the output with one
// global atomicAdd per block and segment. Past that, rows add to the
// output with global atomics directly.
#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ unsigned long long widen(T v) {
  // signed types sign-extend (two's-complement sum), unsigned and bool
  // zero-extend
  return static_cast<unsigned long long>(static_cast<long long>(v));
}

template <>
__device__ __forceinline__ unsigned long long widen<bool>(bool v) {
  return v ? 1ull : 0ull;
}

template <>
__device__ __forceinline__ unsigned long long widen<uint8_t>(uint8_t v) {
  return static_cast<unsigned long long>(v);
}

template <typename T>
__global__ void seg_sum_shared(const T* __restrict__ data,
                               const int* __restrict__ seg, long long n,
                               int k, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long part[];
  for (int s = threadIdx.x; s < k; s += blockDim.x) part[s] = 0ull;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int s = seg[i];
    if (s >= 0 && s < k) atomicAdd(&part[s], widen<T>(data[i]));
  }
  __syncthreads();
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    const unsigned long long v = part[s];
    if (v != 0ull) atomicAdd(&out[s], v);
  }
}

template <typename T>
__global__ void seg_sum_global(const T* __restrict__ data,
                               const int* __restrict__ seg, long long n,
                               int k, unsigned long long* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int s = seg[i];
    if (s >= 0 && s < k) atomicAdd(&out[s], widen<T>(data[i]));
  }
}

constexpr int kThreads = 256;
// 6144 partials * 8 B = 48 KB: the dynamic shared memory a block gets
// without an opt-in attribute
constexpr int kSharedMaxK = 6144;

template <typename T>
void launch(const void* data, const int* seg, long long n, int k,
            unsigned long long* out, cudaStream_t stream) {
  const T* d = static_cast<const T*>(data);
  if (k <= kSharedMaxK) {
    // few blocks, many rows each: the flush costs k atomics per block
    const int blocks = pt::grid_for(n, kThreads * 16, 132 * 4);
    seg_sum_shared<T><<<blocks, kThreads, k * sizeof(unsigned long long),
                        stream>>>(d, seg, n, k, out);
  } else {
    const int blocks = pt::grid_for(n, kThreads, 132 * 32);
    seg_sum_global<T><<<blocks, kThreads, 0, stream>>>(d, seg, n, k, out);
  }
}

}  // namespace

// dtype codes: 0 bool, 1 uint8, 2 int8, 3 int16, 4 int32, 5 int64.
// ``out`` holds k zeros on entry. Returns cudaGetLastError().
extern "C" int pt_segment_sum(const void* data, int dtype, const int* seg,
                              long long n, int k, unsigned long long* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<bool>(data, seg, n, k, out, s); break;
    case 1: launch<uint8_t>(data, seg, n, k, out, s); break;
    case 2: launch<int8_t>(data, seg, n, k, out, s); break;
    case 3: launch<int16_t>(data, seg, n, k, out, s); break;
    case 4: launch<int32_t>(data, seg, n, k, out, s); break;
    case 5: launch<int64_t>(data, seg, n, k, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
