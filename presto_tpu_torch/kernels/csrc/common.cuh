// Shared helpers of the presto_tpu_torch CUDA kernels.
//
// 64-bit hashes arrive as int64 tensors holding uint64 bit patterns
// (presto_tpu_torch/ops/hash.py); the kernels read them as
// unsigned long long. EMPTY (all ones) marks a free table slot; the
// host-side combine_hashes remaps it away from every real row hash.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

constexpr unsigned long long kEmpty = 0xFFFFFFFFFFFFFFFFull;
constexpr unsigned long long kPhi64 = 0x9E3779B97F4A7C15ull;

// murmur3 fmix32: avalanche for open-address slot choice. The row keys
// of integer columns are identity keys (value ^ sign bit), which would
// cluster in a linear-probing table without it.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Home slot of a 64-bit hash: both words avalanche independently
// before folding (the same mix as presto_tpu/kernels/u64.slot32, so a
// key whose two words are equal does not alias into one cluster).
__device__ __forceinline__ uint32_t slot32(unsigned long long h) {
  uint32_t hi = static_cast<uint32_t>(h >> 32);
  uint32_t lo = static_cast<uint32_t>(h);
  return mix32(lo ^ mix32(hi));
}

inline int grid_for(long long n, int threads, int max_blocks) {
  long long b = (n + threads - 1) / threads;
  if (b > max_blocks) b = max_blocks;
  return static_cast<int>(b < 1 ? 1 : b);
}

}  // namespace pt
