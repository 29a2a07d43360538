// How the segmented folds (segment_sum.cu, segment_cmp.cu) read their
// rows and size their grids.
//
// Every fold reads four rows a thread with vector loads (the ids as one
// int4, the values as one 4-, 8- or 16-byte word, int64 as two
// longlong2), two groups in flight, over a grid-stride loop whose grid
// fills the SMs as deep as the kernel's occupancy allows. The wrapper
// (kernels/segagg.vector_span) picks the aligned span
// [vbeg, vbeg + 4 * nvec); rows outside it, and every row when the data
// and the ids are not aligned alike, take scalar loads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace pt {

// The word that holds four values of a type of B bytes (8-byte types
// take two of them).
template <int B>
struct Word;
template <>
struct Word<1> {
  using type = unsigned int;
};
template <>
struct Word<2> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint4;
};

// Four consecutive values from p (aligned to 4 * sizeof(T), at most
// 16).
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, T (&v)[4]) {
  using W = typename Word<sizeof(T)>::type;
  constexpr int kWords = sizeof(T) == 8 ? 2 : 1;
  union {
    W w[kWords];
    T t[4];
  } u;
  const W* q = reinterpret_cast<const W*>(p);
#pragma unroll
  for (int j = 0; j < kWords; ++j) u.w[j] = __ldg(q + j);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = u.t[j];
}

// Calls add(segment id, value) once for every row this thread owns:
// groups of four rows by vector loads in [vbeg, vbeg + 4 * nvec), two
// groups in flight, and single rows outside that span, all over a
// grid-stride loop.
template <typename T, typename Add>
__device__ __forceinline__ void for_rows(const T* __restrict__ data,
                                         const int* __restrict__ seg,
                                         long long n, long long vbeg,
                                         long long nvec, Add&& add) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int4* seg4 = reinterpret_cast<const int4*>(seg + vbeg);
  const T* data4 = data + vbeg;
  long long g = tid;
  for (; g + stride < nvec; g += 2 * stride) {
    const int4 sa = __ldg(seg4 + g);
    const int4 sb = __ldg(seg4 + g + stride);
    T va[4], vb[4];
    load4<T>(data4 + 4 * g, va);
    load4<T>(data4 + 4 * (g + stride), vb);
    add(sa.x, va[0]);
    add(sa.y, va[1]);
    add(sa.z, va[2]);
    add(sa.w, va[3]);
    add(sb.x, vb[0]);
    add(sb.y, vb[1]);
    add(sb.z, vb[2]);
    add(sb.w, vb[3]);
  }
  if (g < nvec) {
    const int4 sa = __ldg(seg4 + g);
    T va[4];
    load4<T>(data4 + 4 * g, va);
    add(sa.x, va[0]);
    add(sa.y, va[1]);
    add(sa.z, va[2]);
    add(sa.w, va[3]);
  }
  for (long long i = tid; i < vbeg; i += stride) {
    add(__ldg(seg + i), data[i]);
  }
  for (long long i = vbeg + 4 * nvec + tid; i < n; i += stride) {
    add(__ldg(seg + i), data[i]);
  }
}

// Blocks of `threads` for n rows (four a thread) on a card of sms SMs
// holding per_sm blocks of the kernel each.
inline int row_blocks(long long n, int threads, int sms, int per_sm) {
  const long long groups = (n + 3) / 4;
  return grid_for(groups, threads, sms * (per_sm < 1 ? 1 : per_sm));
}

// Blocks of `threads` with `smem` bytes of dynamic shared memory that
// one SM holds at once.
template <typename K>
int resident(K kernel, int threads, int smem) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return per_sm;
}

inline int sm_count() {
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace pt
