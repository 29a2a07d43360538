// Shared helpers of the presto_tpu_torch CUDA kernels.
//
// 64-bit hashes arrive as int64 tensors holding uint64 bit patterns
// (presto_tpu_torch/ops/hash.py); the kernels read them as
// unsigned long long. EMPTY (all ones) marks a free table slot; the
// host-side combine_hashes remaps it away from every real row hash.
//
// A hash table (build_table, probe_table, multijoin_walk) is one array
// of 16-byte slots {uint64 key; int32 row; int32 pad}, held as an int64
// tensor [cap, 2]. An empty slot is all ones: key EMPTY, row -1.
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

// One hash-table slot. Key and row share a 32-byte DRAM sector, so a
// build's claim and its row update, and a probe's test and its row
// read, touch one sector.
struct __align__(16) Slot {
  unsigned long long key;
  int row;
  int pad;
};

// Key and row of a slot in one 16-byte read-only load (the row is the
// low word of the second half). Plain caching: it allocates in L1,
// since probe keys that arrive clustered (a lineitem spine in order)
// read one slot from several warps of an SM in turn, and
// L1::no_allocate doubled Q21's walk; and no L2 policy, since an
// evict_last policy made no difference at the kernel phase's random
// keys or on the queries (PERF.md).
__device__ __forceinline__ void load_slot(const Slot* __restrict__ table,
                                          uint32_t slot,
                                          unsigned long long& key,
                                          int& row) {
  const longlong2 s = __ldg(reinterpret_cast<const longlong2*>(table) + slot);
  key = static_cast<unsigned long long>(s.x);
  row = static_cast<int>(s.y);
}

// Looks up hash h of a live row with linear probing from its home
// slot. A slot whose key equals h is a match, tested BEFORE empty, as
// the reference's probe does (h may equal the EMPTY sentinel); an
// empty slot ends a miss; a row that passes max_probes slots undecided
// clears ok. Returns whether h matched, and sets row to the matching
// slot's row (-1 for an empty slot matched by EMPTY).
__device__ __forceinline__ bool probe(const Slot* __restrict__ table,
                                     uint32_t mask, int max_probes,
                                     unsigned long long h, int& row,
                                     int* __restrict__ ok) {
  uint32_t slot = slot32(h) & mask;
  for (int left = max_probes; left > 0; --left) {
    unsigned long long key;
    int r;
    load_slot(table, slot, key, r);
    if (key == h) {
      row = r;
      return true;
    }
    if (key == kEmpty) return false;
    slot = (slot + 1u) & mask;
  }
  atomicExch(ok, 0);  // the chain passed max_probes undecided
  return false;
}

inline int grid_for(long long n, int threads, int max_blocks) {
  long long b = (n + threads - 1) / threads;
  if (b > max_blocks) b = max_blocks;
  return static_cast<int>(b < 1 ? 1 : b);
}

}  // namespace pt
