// Hash-join build and probe over one open-addressing table.
//
// Replaces: build_table (presto_tpu/kernels/hashjoin.py:59) and
// probe_table (presto_tpu/kernels/hashjoin.py:151). On the TPU the
// table lives in VMEM across a sequential grid, so inserts need no
// atomics, hashes ride as two uint32 planes (no 64-bit ALU), and
// tables above 1<<20 slots fall back to the sort path.
//
// Bound on this card: bytes, and the latency of dependent random
// loads. The build reads each live row's hash and writes one 8-byte
// key and one 4-byte row per slot touched; the probe reads each probe
// row's hash and one or a few table slots, and writes a 4-byte row and
// a 1-byte flag. Those random slot accesses are served from HBM once
// the table outgrows the 50 MB L2 (Q5's orders table at SF10 is 32M
// slots, 384 MB).
//
// Design: one 64-bit key plane (native 64-bit compare and atomicCAS)
// plus an int32 row plane; the table takes any size that fits in
// device memory. Build: one thread per build row claims its slot with
// atomicCAS(key, EMPTY, h); a slot that was empty or already held h is
// the row's, and atomicMax on the row plane keeps the largest row index
// on duplicate keys (the reference's representative). Otherwise the
// row walks on by linear probing, at most max_probes slots; a row still
// unplaced clears ok, and the executor's capacity ladder rebuilds
// larger. Probe: one thread per probe row, read-only, tests a match
// BEFORE empty, exactly as the reference (a hash may equal the
// sentinel). Concurrent inserts can lay out chains in another order
// than the sequential TPU grid, so on a nearly full table ok may
// differ from the reference's; build_row and found cannot.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void build_table_kernel(const long long* __restrict__ hash,
                                   const bool* __restrict__ live,
                                   long long n,
                                   unsigned long long* __restrict__ keys,
                                   int* __restrict__ rows, uint32_t mask,
                                   int max_probes, int* __restrict__ ok) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || !live[i]) return;
  const unsigned long long h = static_cast<unsigned long long>(hash[i]);
  uint32_t slot = pt::slot32(h) & mask;
  for (int j = 0; j < max_probes; ++j) {
    const unsigned long long prev = atomicCAS(&keys[slot], pt::kEmpty, h);
    if (prev == pt::kEmpty || prev == h) {
      atomicMax(&rows[slot], static_cast<int>(i));
      return;
    }
    slot = (slot + 1u) & mask;
  }
  atomicExch(ok, 0);
}

__global__ void probe_table_kernel(const unsigned long long* __restrict__ keys,
                                   const int* __restrict__ rows,
                                   uint32_t mask,
                                   const long long* __restrict__ hash,
                                   const bool* __restrict__ live,
                                   long long n, int max_probes,
                                   int* __restrict__ build_row,
                                   bool* __restrict__ found,
                                   int* __restrict__ ok) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int row = -1;
  bool hit = false;
  if (live[i]) {
    const unsigned long long h = static_cast<unsigned long long>(hash[i]);
    uint32_t slot = pt::slot32(h) & mask;
    bool decided = false;
    for (int j = 0; j < max_probes; ++j) {
      const unsigned long long t = keys[slot];
      if (t == h) {  // match first: h may equal the EMPTY sentinel
        row = rows[slot];
        hit = true;
        decided = true;
        break;
      }
      if (t == pt::kEmpty) {
        decided = true;
        break;
      }
      slot = (slot + 1u) & mask;
    }
    if (!decided) atomicExch(ok, 0);
  }
  build_row[i] = row;
  found[i] = hit;
}

}  // namespace

// keys (cap, all EMPTY), rows (cap, all -1) and ok (1, set to 1) are
// initialised by the caller; cap is a power of two. Returns
// cudaGetLastError().
extern "C" int pt_build_table(const long long* hash, const bool* live,
                              long long n, unsigned long long* keys,
                              int* rows, long long cap, int max_probes,
                              int* ok, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    build_table_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        hash, live, n, keys, rows, static_cast<uint32_t>(cap - 1),
        max_probes, ok);
  }
  return static_cast<int>(cudaGetLastError());
}

// ok (1, set to 1) is initialised by the caller.
extern "C" int pt_probe_table(const unsigned long long* keys,
                              const int* rows, long long cap,
                              const long long* hash, const bool* live,
                              long long n, int max_probes, int* build_row,
                              bool* found, int* ok, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    probe_table_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        keys, rows, static_cast<uint32_t>(cap - 1), hash, live, n,
        max_probes, build_row, found, ok);
  }
  return static_cast<int>(cudaGetLastError());
}
