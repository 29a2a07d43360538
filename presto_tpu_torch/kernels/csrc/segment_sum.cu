// segment_sum: per-segment sum of an integer or bool column, wrapping
// mod 2^64; segment ids outside [0, k) drop.
//
// Replaces: segment_sum_pallas (presto_tpu/kernels/segagg.py:68), the
// TPU kernel that walks 256-row tiles sequentially and carries two
// uint32 accumulator planes in VMEM (the TPU has no 64-bit ALU).
//
// Bound on this card: bytes. Each row is read once (data + a 4-byte
// segment id) and does one 64-bit add, so the floor is
// (n * (sizeof(T) + 4) + k * 8) / 3.35 TB/s. What kept the first
// design off it was not the bytes but where the adds went: every row
// was a 64-bit shared-memory atomic, and at Q1's k = 6 a block's 256
// threads serialised on six words; every thread loaded one value and
// one id at a time.
//
// Design: Hopper has native 64-bit atomics, so the limb planes go.
// Integer addition mod 2^64 is order-free, so the result is
// bit-identical to the reference in any accumulation order. Every path
// reads its rows as segrows.cuh says (four a thread by vector loads,
// an occupancy-sized grid-stride grid). Then, by k:
// - k <= 8 (Q1's k = 6, every global fold's k = 1, Q4, Q12): each
//   thread keeps KP accumulators in registers, KP = k rounded up to a
//   power of two, and adds each row with a fully unrolled
//   compare-and-select over KP (no atomic per row; ids in [k, KP) land
//   in accumulators that are never flushed, so they drop). The block
//   reduces each accumulator with warp shuffles, then across its warps
//   in shared memory, and adds each nonzero total to the output with
//   one global atomic.
// - 8 < k <= 32: the compare-and-select costs KP selects and 64-bit
//   adds a row, and at KP = 32 those instructions, not the bytes, set
//   the time (0.52 ms against 0.25 at k = 6 over 60M int64 rows,
//   chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W; KP = 32 held
//   95-97 registers, with no stack frame and no spills, under ptxas -v
//   for sm_90a, CUDA 12.8). So each lane keeps its KP accumulators in
//   its own column of shared memory instead and adds a row with one
//   load and one store, whatever KP; the flush sums the block's 256
//   columns per segment.
// - 32 < k <= 6144: per-segment partials in shared memory, one copy a
//   warp while k * 8 bytes * copies fits the 48 KB a block gets without
//   an opt-in (k <= 768 with 8 warps), so an address is contended by 32
//   lanes, not 256; the copies are added in the flush, one global
//   atomic per block and nonzero segment.
// - k > 6144: global atomics straight to the output.
// Zero values add nothing and skip their atomic.
#include "segrows.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneMaxK = 32;
// 48 KB: the dynamic shared memory a block gets without an opt-in
constexpr int kSharedBytes = 48 * 1024;
constexpr int kSharedMaxK = kSharedBytes / 8;

template <typename T>
__device__ __forceinline__ u64 widen(T v) {
  // signed types sign-extend (two's-complement sum), unsigned and bool
  // zero-extend
  return static_cast<u64>(static_cast<long long>(v));
}

template <>
__device__ __forceinline__ u64 widen<bool>(bool v) {
  return v ? 1ull : 0ull;
}

template <>
__device__ __forceinline__ u64 widen<uint8_t>(uint8_t v) {
  return static_cast<u64>(v);
}

template <typename T, int KP>
__global__ void __launch_bounds__(kThreads)
    seg_sum_reg(const T* __restrict__ data, const int* __restrict__ seg,
                long long n, long long vbeg, long long nvec, int k,
                u64* __restrict__ out) {
  u64 acc[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) acc[j] = 0ull;
  pt::for_rows<T>(data, seg, n, vbeg, nvec, [&](int s, T t) {
    const u64 v = widen<T>(t);
#pragma unroll
    for (int j = 0; j < KP; ++j) acc[j] += s == j ? v : 0ull;
  });
  __shared__ u64 part[kWarps][KP];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    u64 x = acc[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
    if (lane == 0) part[warp][j] = x;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < k) {  // k <= KP: k..KP-1 drop
    u64 x = 0ull;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += part[w][threadIdx.x];
    if (x != 0ull) atomicAdd(&out[threadIdx.x], x);
  }
}

// 8 < k <= 32: each lane owns a column of KP accumulators in shared
// memory, [warp][KP][32 lanes], and adds its rows with plain loads and
// stores (the lane's own words: no atomic, no bank conflict).
template <typename T, int KP>
__global__ void __launch_bounds__(kThreads)
    seg_sum_lanes(const T* __restrict__ data, const int* __restrict__ seg,
                  long long n, long long vbeg, long long nvec, int k,
                  u64* __restrict__ out) {
  extern __shared__ u64 acc[];
  for (int s = threadIdx.x; s < kWarps * KP * 32; s += blockDim.x) {
    acc[s] = 0ull;
  }
  __syncthreads();
  u64* mine = acc + (threadIdx.x >> 5) * KP * 32 + (threadIdx.x & 31);
  pt::for_rows<T>(data, seg, n, vbeg, nvec, [&](int s, T t) {
    if (static_cast<unsigned>(s) < static_cast<unsigned>(KP)) {
      mine[s * 32] += widen<T>(t);
    }
  });
  __syncthreads();
  for (int s = threadIdx.x; s < k; s += blockDim.x) {  // k..KP-1 drop
    u64 x = 0ull;
    for (int w = 0; w < kWarps; ++w) {
      for (int l = 0; l < 32; ++l) x += acc[(w * KP + s) * 32 + l];
    }
    if (x != 0ull) atomicAdd(&out[s], x);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    seg_sum_shared(const T* __restrict__ data, const int* __restrict__ seg,
                   long long n, long long vbeg, long long nvec, int k,
                   int copies, u64* __restrict__ out) {
  extern __shared__ u64 part[];
  for (int s = threadIdx.x; s < k * copies; s += blockDim.x) part[s] = 0ull;
  __syncthreads();
  // copies is a power of two dividing kWarps
  u64* mine = part + ((threadIdx.x >> 5) & (copies - 1)) * k;
  const unsigned uk = static_cast<unsigned>(k);
  pt::for_rows<T>(data, seg, n, vbeg, nvec, [&](int s, T t) {
    const u64 v = widen<T>(t);
    if (static_cast<unsigned>(s) < uk && v != 0ull) atomicAdd(&mine[s], v);
  });
  __syncthreads();
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    u64 x = 0ull;
    for (int c = 0; c < copies; ++c) x += part[c * k + s];
    if (x != 0ull) atomicAdd(&out[s], x);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    seg_sum_global(const T* __restrict__ data, const int* __restrict__ seg,
                   long long n, long long vbeg, long long nvec, int k,
                   u64* __restrict__ out) {
  const unsigned uk = static_cast<unsigned>(k);
  pt::for_rows<T>(data, seg, n, vbeg, nvec, [&](int s, T t) {
    const u64 v = widen<T>(t);
    if (static_cast<unsigned>(s) < uk && v != 0ull) atomicAdd(&out[s], v);
  });
}

template <typename T, int KP>
void launch_reg(const T* d, const int* seg, long long n, long long vbeg,
                long long nvec, int k, u64* out, int sms, cudaStream_t s) {
  static const int per_sm = pt::resident(seg_sum_reg<T, KP>, kThreads, 0);
  const int blocks = pt::row_blocks(n, kThreads, sms, per_sm);
  seg_sum_reg<T, KP><<<blocks, kThreads, 0, s>>>(d, seg, n, vbeg, nvec, k,
                                                out);
}

template <typename T, int KP>
void launch_lanes(const T* d, const int* seg, long long n, long long vbeg,
                  long long nvec, int k, u64* out, int sms, cudaStream_t s) {
  constexpr int kSmem = kWarps * KP * 32 * 8;  // 64 KB at KP = 32
  static const int per_sm = [] {
    cudaFuncSetAttribute(seg_sum_lanes<T, KP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    return pt::resident(seg_sum_lanes<T, KP>, kThreads, kSmem);
  }();
  const int blocks = pt::row_blocks(n, kThreads, sms, per_sm);
  seg_sum_lanes<T, KP><<<blocks, kThreads, kSmem, s>>>(d, seg, n, vbeg, nvec,
                                                      k, out);
}

template <typename T>
void launch(const void* data, const int* seg, long long n, int k,
            long long vbeg, long long nvec, u64* out, cudaStream_t s) {
  const T* d = static_cast<const T*>(data);
  const int sms = pt::sm_count();
  if (k <= kLaneMaxK) {
    if (k == 1) {
      launch_reg<T, 1>(d, seg, n, vbeg, nvec, k, out, sms, s);
    } else if (k == 2) {
      launch_reg<T, 2>(d, seg, n, vbeg, nvec, k, out, sms, s);
    } else if (k <= 4) {
      launch_reg<T, 4>(d, seg, n, vbeg, nvec, k, out, sms, s);
    } else if (k <= 8) {
      launch_reg<T, 8>(d, seg, n, vbeg, nvec, k, out, sms, s);
    } else if (k <= 16) {
      launch_lanes<T, 16>(d, seg, n, vbeg, nvec, k, out, sms, s);
    } else {
      launch_lanes<T, 32>(d, seg, n, vbeg, nvec, k, out, sms, s);
    }
  } else if (k <= kSharedMaxK) {
    int copies = kWarps;
    while (copies > 1 && k * 8 * copies > kSharedBytes) copies >>= 1;
    const int smem = k * 8 * copies;
    const int blocks = pt::row_blocks(
        n, kThreads, sms, pt::resident(seg_sum_shared<T>, kThreads, smem));
    seg_sum_shared<T><<<blocks, kThreads, smem, s>>>(d, seg, n, vbeg, nvec, k,
                                                     copies, out);
  } else {
    static const int per_sm = pt::resident(seg_sum_global<T>, kThreads, 0);
    const int blocks = pt::row_blocks(n, kThreads, sms, per_sm);
    seg_sum_global<T><<<blocks, kThreads, 0, s>>>(d, seg, n, vbeg, nvec, k,
                                                  out);
  }
}

}  // namespace

// dtype codes: 0 bool, 1 uint8, 2 int8, 3 int16, 4 int32, 5 int64.
// ``out`` holds k zeros on entry. Rows [vbeg, vbeg + 4 * nvec) are read
// with vector loads: seg + vbeg is 16-byte aligned and data + vbeg is
// aligned to min(4 * sizeof(T), 16) bytes (the wrapper checks). Returns
// cudaGetLastError().
extern "C" int pt_segment_sum(const void* data, int dtype, const int* seg,
                              long long n, int k, long long vbeg,
                              long long nvec, unsigned long long* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<bool>(data, seg, n, k, vbeg, nvec, out, s); break;
    case 1: launch<uint8_t>(data, seg, n, k, vbeg, nvec, out, s); break;
    case 2: launch<int8_t>(data, seg, n, k, vbeg, nvec, out, s); break;
    case 3: launch<int16_t>(data, seg, n, k, vbeg, nvec, out, s); break;
    case 4: launch<int32_t>(data, seg, n, k, vbeg, nvec, out, s); break;
    case 5: launch<int64_t>(data, seg, n, k, vbeg, nvec, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
