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
// Bound on this card: bytes. Each row is read once (the value and a
// 4-byte segment id) and does one compare, far below the integer
// rate, so the floor is (n * (sizeof(T) + 4) + k * 8) / 3.35 TB/s.
// What kept the first design off it was where the compares went, as
// in segment_sum.cu before its redesign: at a handful of groups every
// row was a 64-bit shared-memory atomic on one of k words contended by
// a block's 256 threads, and past 6144 groups every row was an L2
// atomic.
//
// Design: Hopper has native 64-bit atomicMax/atomicMin, so the limb
// planes go. Values widen (signed types sign-extend, uint8
// zero-extends; both keep the order). Rows are read as segrows.cuh
// says (four a thread by vector loads, an occupancy-sized grid-stride
// grid). Max and min are order-free, so any order of updates gives the
// reference's bits, and they are idempotent, which a sum is not: a row
// that does not beat the partial it would update can skip its update.
// Every atomic below stands behind a plain read of its partial and is
// skipped when the row does not beat it. A stale read is safe: a
// partial only moves one way (up for max), so a value read earlier is
// never beyond the true one, and a row that does not beat the stale
// value cannot beat the true one; a stale read can only let through an
// atomic that was not needed. With rows in random order a segment's
// partial moves about H(m) times over its m rows, so most rows skip;
// rows that ascend (for max) defeat this and pay a read and an atomic
// each. By k:
// - k <= 8 (Q15's k = 1, a direct group-by's k = 6): each thread keeps
//   KP partials in registers, KP = k rounded up to a power of two, in
//   32 bits for types of up to 4 bytes, and folds each row in with an
//   unrolled compare-select over KP (ids in [k, KP) land in partials
//   that are never flushed, so they drop). The block reduces each
//   partial with warp shuffles, then across its warps in shared memory,
//   and makes one global atomic per segment, only if it moved the
//   output.
// - 8 < k <= 32: each lane owns a column of KP partials in shared
//   memory and updates them with plain loads and stores (no atomic:
//   no other thread writes the column); the flush reduces the block's
//   256 columns per segment.
// - 32 < k <= 6144: per-segment partials in shared memory, one copy a
//   warp while k * 8 bytes * copies fits the 48 KB a block gets without
//   an opt-in, updated by shared atomics behind a read.
// - k > 6144: global atomics behind a read of out[s] (at L2: the
//   segment's word lives there while the output fits the 50 MB L2).
#include <limits>
#include <type_traits>

#include "segrows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneMaxK = 32;
// 48 KB: the dynamic shared memory a block gets without an opt-in
constexpr int kSharedBytes = 48 * 1024;
constexpr int kSharedMaxK = kSharedBytes / 8;

// The register and lane partials of a type: 32 bits for up to 4 bytes
// (half the compare and shuffle work), else 64.
template <typename T>
using Acc = typename std::conditional<sizeof(T) == 8, long long, int>::type;

template <bool kMax, typename A>
__device__ __forceinline__ bool beats(A a, A b) {
  return kMax ? a > b : a < b;
}

template <bool kMax, typename A>
__device__ __forceinline__ A better(A a, A b) {
  return beats<kMax>(a, b) ? a : b;
}

template <bool kMax>
__device__ __forceinline__ void atomic_better(long long* p, long long v) {
  if (kMax) {
    atomicMax(p, v);
  } else {
    atomicMin(p, v);
  }
}

// Folds v into the output word p: an atomic only when v beats the
// word as read at L2 (stale is safe: see the header).
template <bool kMax>
__device__ __forceinline__ void fold_global(long long* p, long long v) {
  if (beats<kMax>(v, __ldcg(p))) atomic_better<kMax>(p, v);
}

template <typename T, int KP, bool kMax>
__global__ void __launch_bounds__(kThreads)
    seg_cmp_reg(const T* __restrict__ data, const int* __restrict__ seg,
                long long n, long long vbeg, long long nvec, int k,
                long long ident, long long* __restrict__ out) {
  using A = Acc<T>;
  const A id = static_cast<A>(ident);
  A acc[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) acc[j] = id;
  pt::for_rows<T>(data, seg, n, vbeg, nvec, [&](int s, T t) {
    const A v = static_cast<A>(t);
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      acc[j] = s == j && beats<kMax>(v, acc[j]) ? v : acc[j];
    }
  });
  __shared__ A part[kWarps][KP];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    A x = acc[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      x = better<kMax>(x, __shfl_xor_sync(0xFFFFFFFFu, x, o));
    }
    if (lane == 0) part[warp][j] = x;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < k) {  // k <= KP: k..KP-1 drop
    A x = id;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x = better<kMax>(x, part[w][threadIdx.x]);
    fold_global<kMax>(&out[threadIdx.x], static_cast<long long>(x));
  }
}

// 8 < k <= 32: each lane owns a column of KP partials in shared memory,
// [warp][KP][32 lanes], and updates it with plain loads and stores.
template <typename T, int KP, bool kMax>
__global__ void __launch_bounds__(kThreads)
    seg_cmp_lanes(const T* __restrict__ data, const int* __restrict__ seg,
                  long long n, long long vbeg, long long nvec, int k,
                  long long ident, long long* __restrict__ out) {
  using A = Acc<T>;
  const A id = static_cast<A>(ident);
  extern __shared__ __align__(16) unsigned char smem[];
  A* acc = reinterpret_cast<A*>(smem);
  for (int s = threadIdx.x; s < kWarps * KP * 32; s += blockDim.x) {
    acc[s] = id;
  }
  __syncthreads();
  A* mine = acc + (threadIdx.x >> 5) * KP * 32 + (threadIdx.x & 31);
  pt::for_rows<T>(data, seg, n, vbeg, nvec, [&](int s, T t) {
    if (static_cast<unsigned>(s) < static_cast<unsigned>(KP)) {
      const A v = static_cast<A>(t);
      A* p = mine + s * 32;
      if (beats<kMax>(v, *p)) *p = v;
    }
  });
  __syncthreads();
  for (int s = threadIdx.x; s < k; s += blockDim.x) {  // k..KP-1 drop
    A x = id;
    for (int w = 0; w < kWarps; ++w) {
      for (int l = 0; l < 32; ++l) {
        x = better<kMax>(x, acc[(w * KP + s) * 32 + l]);
      }
    }
    fold_global<kMax>(&out[s], static_cast<long long>(x));
  }
}

template <typename T, bool kMax>
__global__ void __launch_bounds__(kThreads)
    seg_cmp_shared(const T* __restrict__ data, const int* __restrict__ seg,
                   long long n, long long vbeg, long long nvec, int k,
                   int copies, long long ident, long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* part = reinterpret_cast<long long*>(smem);
  for (int s = threadIdx.x; s < k * copies; s += blockDim.x) part[s] = ident;
  __syncthreads();
  // copies is a power of two dividing kWarps
  long long* mine = part + ((threadIdx.x >> 5) & (copies - 1)) * k;
  const unsigned uk = static_cast<unsigned>(k);
  pt::for_rows<T>(data, seg, n, vbeg, nvec, [&](int s, T t) {
    const long long v = static_cast<long long>(t);
    if (static_cast<unsigned>(s) < uk && beats<kMax>(v, mine[s])) {
      atomic_better<kMax>(&mine[s], v);
    }
  });
  __syncthreads();
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    long long x = ident;
    for (int c = 0; c < copies; ++c) x = better<kMax>(x, part[c * k + s]);
    fold_global<kMax>(&out[s], x);
  }
}

template <typename T, bool kMax>
__global__ void __launch_bounds__(kThreads)
    seg_cmp_global(const T* __restrict__ data, const int* __restrict__ seg,
                   long long n, long long vbeg, long long nvec, int k,
                   long long* __restrict__ out) {
  const unsigned uk = static_cast<unsigned>(k);
  pt::for_rows<T>(data, seg, n, vbeg, nvec, [&](int s, T t) {
    if (static_cast<unsigned>(s) < uk) {
      fold_global<kMax>(&out[s], static_cast<long long>(t));
    }
  });
}

template <typename T, int KP, bool kMax>
void launch_reg(const T* d, const int* seg, long long n, long long vbeg,
                long long nvec, int k, long long ident, long long* out,
                int sms, cudaStream_t s) {
  static const int per_sm =
      pt::resident(seg_cmp_reg<T, KP, kMax>, kThreads, 0);
  const int blocks = pt::row_blocks(n, kThreads, sms, per_sm);
  seg_cmp_reg<T, KP, kMax><<<blocks, kThreads, 0, s>>>(d, seg, n, vbeg, nvec,
                                                       k, ident, out);
}

template <typename T, int KP, bool kMax>
void launch_lanes(const T* d, const int* seg, long long n, long long vbeg,
                  long long nvec, int k, long long ident, long long* out,
                  int sms, cudaStream_t s) {
  // 64 KB for int64 at KP = 32
  constexpr int kSmem = kWarps * KP * 32 * sizeof(Acc<T>);
  static const int per_sm = [] {
    cudaFuncSetAttribute(seg_cmp_lanes<T, KP, kMax>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    return pt::resident(seg_cmp_lanes<T, KP, kMax>, kThreads, kSmem);
  }();
  const int blocks = pt::row_blocks(n, kThreads, sms, per_sm);
  seg_cmp_lanes<T, KP, kMax><<<blocks, kThreads, kSmem, s>>>(
      d, seg, n, vbeg, nvec, k, ident, out);
}

template <typename T, bool kMax>
void launch(const void* data, const int* seg, long long n, int k,
            long long vbeg, long long nvec, long long* out, cudaStream_t s) {
  const T* d = static_cast<const T*>(data);
  // the identity the wrapper filled the output with
  const long long ident =
      kMax ? static_cast<long long>(std::numeric_limits<T>::min())
           : static_cast<long long>(std::numeric_limits<T>::max());
  const int sms = pt::sm_count();
  if (k == 1) {
    launch_reg<T, 1, kMax>(d, seg, n, vbeg, nvec, k, ident, out, sms, s);
  } else if (k == 2) {
    launch_reg<T, 2, kMax>(d, seg, n, vbeg, nvec, k, ident, out, sms, s);
  } else if (k <= 4) {
    launch_reg<T, 4, kMax>(d, seg, n, vbeg, nvec, k, ident, out, sms, s);
  } else if (k <= 8) {
    launch_reg<T, 8, kMax>(d, seg, n, vbeg, nvec, k, ident, out, sms, s);
  } else if (k <= 16) {
    launch_lanes<T, 16, kMax>(d, seg, n, vbeg, nvec, k, ident, out, sms, s);
  } else if (k <= kLaneMaxK) {
    launch_lanes<T, 32, kMax>(d, seg, n, vbeg, nvec, k, ident, out, sms, s);
  } else if (k <= kSharedMaxK) {
    int copies = kWarps;
    while (copies > 1 && k * 8 * copies > kSharedBytes) copies >>= 1;
    const int smem_bytes = k * 8 * copies;
    const int blocks = pt::row_blocks(
        n, kThreads, sms,
        pt::resident(seg_cmp_shared<T, kMax>, kThreads, smem_bytes));
    seg_cmp_shared<T, kMax><<<blocks, kThreads, smem_bytes, s>>>(
        d, seg, n, vbeg, nvec, k, copies, ident, out);
  } else {
    static const int per_sm =
        pt::resident(seg_cmp_global<T, kMax>, kThreads, 0);
    const int blocks = pt::row_blocks(n, kThreads, sms, per_sm);
    seg_cmp_global<T, kMax><<<blocks, kThreads, 0, s>>>(d, seg, n, vbeg,
                                                        nvec, k, out);
  }
}

template <bool kMax>
int dispatch(const void* data, int dtype, const int* seg, long long n, int k,
             long long vbeg, long long nvec, long long* out,
             cudaStream_t s) {
  using Launch = void (*)(const void*, const int*, long long, int, long long,
                         long long, long long*, cudaStream_t);
  static constexpr Launch kLaunch[] = {
      launch<uint8_t, kMax>, launch<int8_t, kMax>, launch<int16_t, kMax>,
      launch<int32_t, kMax>, launch<int64_t, kMax>};
  if (dtype < 1 || dtype > 5) return static_cast<int>(cudaErrorInvalidValue);
  kLaunch[dtype - 1](data, seg, n, k, vbeg, nvec, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes as pt_segment_sum's (bool excluded): 1 uint8, 2 int8,
// 3 int16, 4 int32, 5 int64. ``out`` holds k copies of the dtype's
// identity (widened to int64) on entry. Rows [vbeg, vbeg + 4 * nvec)
// are read with vector loads, aligned as pt_segment_sum's. Returns
// cudaGetLastError().
extern "C" int pt_segment_cmp(const void* data, int dtype, const int* seg,
                              long long n, int k, int is_max, long long vbeg,
                              long long nvec, long long* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_max ? dispatch<true>(data, dtype, seg, n, k, vbeg, nvec, out, s)
                : dispatch<false>(data, dtype, seg, n, k, vbeg, nvec, out, s);
}
