// Hash-join build and probe over one open-addressing table of 16-byte
// slots.
//
// Replaces: build_table (presto_tpu/kernels/hashjoin.py:59) and
// probe_table (presto_tpu/kernels/hashjoin.py:151). On the TPU the
// table lives in VMEM across a sequential grid, so inserts need no
// atomics, hashes ride as two uint32 planes (no 64-bit ALU), and
// tables above 1<<20 slots fall back to the sort path.
//
// Bound on this card: bytes, and the latency of random accesses. The
// build reads each live row's hash and touches one or a few slots; the
// probe reads each probe row's hash and one or a few slots, and writes
// a 4-byte row and a 1-byte flag. Once the table outgrows the 50 MB L2
// (Q5's orders table at SF10 is 2^25 slots, 512 MB) every first touch
// of a slot is a DRAM sector round trip, and those round trips, not
// the streamed bytes, set the time.
//
// Design: one array of slots {uint64 key; int32 row; int32 pad}
// (common.cuh), so a slot's key and row lie in one 32-byte sector. The
// two-plane layout before it (8-byte keys, 4-byte rows) paid two DRAM
// round trips for each insert and each probe hit; one sector pays one.
// An empty slot is all ones (key EMPTY, row -1), so the wrapper fills
// the table with one fill. Two slots share a sector, so a probe
// chain's next slot is often already in L2.
//
// Build: one thread per build row claims its slot with
// atomicCAS(key, EMPTY, h); a slot that was empty or already held h is
// the row's, and atomicMax on the slot's row (an L2 hit: the CAS just
// brought the sector in) keeps the largest row index on duplicate keys
// (the reference's representative). Otherwise the row walks on by
// linear probing from pt::slot32(h), at most max_probes slots; a row
// still unplaced clears ok, and the executor's capacity ladder
// rebuilds larger. Inserts in row order land on random slots, so a
// table past the L2 pays a DRAM round trip per insert. A table the
// wrapper deems larger than the L2 therefore builds in three passes:
// count the live rows per bucket (the top 8 bits of the home slot);
// partition them, each block ranking its 4096 rows by bucket in shared
// memory and writing each bucket's run contiguously into a scratch
// (hash, row) pair; then insert from the scratch in bucket order, so
// the blocks in flight at any moment touch a few buckets' slots, a few
// MB that stay in L2, and the table streams through DRAM about once.
// 15M rows into 2^25 slots took 2.0 ms in row order, 2.3 ms
// partitioned with each row stored straight from registers (scattered
// 8-byte stores) and 1.1 ms staged as here, the table's fill included
// (kernel_ab.py on an NVIDIA H100 80GB HBM3 at 700 W).
//
// Probe: read-only, one probe row a thread, one 16-byte load a slot
// that tests a match BEFORE empty, exactly as the reference (a hash may
// equal the sentinel). 60M probes into 2^25 slots take about 2.46 ms,
// within 1.1x of the random-read floor of their 57M first slots alone
// (an index_select of as many random 16-byte slots, 2.24-2.28 ms): the
// card's random DRAM reads, not the kernel, set the time. Several probe
// rows a thread, with all their first reads in flight, were no faster
// (2, 4 or 8 rows: 2.45, 2.48, 2.81 ms), and evict-first hints on the
// streamed columns lost on the queries' probe traffic (kernel_ab.py
// and profile_port.py on an NVIDIA H100 80GB HBM3 at 700 W).
// Concurrent inserts can lay out chains in another order than the
// sequential TPU grid, so on a nearly full table ok may differ from the
// reference's; build_row and found cannot.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Partitioned builds: the live rows go to kParts buckets by the top 8
// bits of their home slot. A block partitions kPartRows rows, 16 a
// thread, and stages them by bucket in shared memory (kStageBytes) so
// each bucket's run leaves the block as one contiguous write.
constexpr int kPartBits = 8;
constexpr int kParts = 1 << kPartBits;
constexpr int kPartItems = 16;
constexpr int kPartRows = kPartItems * kThreads;
constexpr int kStageBytes = kPartRows * (8 + 4);
static_assert(kParts == kThreads, "the partition scans one bucket a thread");

// Insert hash h of build row `row`: claim a slot along the chain from
// h's home, keep the largest row, clear ok past max_probes.
__device__ __forceinline__ void insert(pt::Slot* __restrict__ table,
                                       uint32_t mask, int max_probes,
                                       unsigned long long h, int row,
                                       int* __restrict__ ok) {
  uint32_t slot = pt::slot32(h) & mask;
  for (int j = 0; j < max_probes; ++j) {
    const unsigned long long prev =
        atomicCAS(&table[slot].key, pt::kEmpty, h);
    if (prev == pt::kEmpty || prev == h) {
      atomicMax(&table[slot].row, row);
      return;
    }
    slot = (slot + 1u) & mask;
  }
  atomicExch(ok, 0);
}

__global__ void build_table_kernel(const long long* __restrict__ hash,
                                   const bool* __restrict__ live,
                                   long long n, pt::Slot* __restrict__ table,
                                   uint32_t mask, int max_probes,
                                   int* __restrict__ ok) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || !live[i]) return;
  insert(table, mask, max_probes, static_cast<unsigned long long>(hash[i]),
         static_cast<int>(i), ok);
}

__device__ __forceinline__ int bucket_of(long long h, uint32_t mask,
                                         int shift) {
  return static_cast<int>(
      (pt::slot32(static_cast<unsigned long long>(h)) & mask) >> shift);
}

// This thread's rows of the block's tile (row base + j * kThreads +
// thread), with their hashes and liveness, loaded before any is used.
struct Tile {
  long long h[kPartItems];
  bool live[kPartItems];
};

__device__ __forceinline__ void load_tile(const long long* __restrict__ hash,
                                          const bool* __restrict__ live,
                                          long long n, Tile& t) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kPartRows + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPartItems; ++j) {
    const long long i = base + j * kThreads;
    t.live[j] = i < n && live[i];
    t.h[j] = i < n ? hash[i] : 0;
  }
}

// Exclusive prefix sum of one int a thread over the block (kThreads
// values, Hillis-Steele in buf); returns this thread's.
__device__ __forceinline__ int block_exclusive(int v, int* buf) {
  const int t = threadIdx.x;
  buf[t] = v;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int add = t >= off ? buf[t - off] : 0;
    __syncthreads();
    buf[t] += add;
    __syncthreads();
  }
  return buf[t] - v;
}

// counters[0, kParts): live rows per bucket, summed over the blocks.
__global__ void part_count_kernel(const long long* __restrict__ hash,
                                  const bool* __restrict__ live, long long n,
                                  uint32_t mask, int shift,
                                  int* __restrict__ counters) {
  __shared__ int hist[kParts];
  hist[threadIdx.x] = 0;
  Tile t;
  load_tile(hash, live, n, t);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPartItems; ++j) {
    if (t.live[j]) atomicAdd(&hist[bucket_of(t.h[j], mask, shift)], 1);
  }
  __syncthreads();
  const int c = hist[threadIdx.x];
  if (c) atomicAdd(&counters[threadIdx.x], c);
}

// Writes each live row's (hash, row) into its bucket's range of
// part_hash/part_row, buckets in home-slot order. The block ranks its
// tile's rows by bucket in shared memory, reserves a run in each
// bucket's range (counters[kParts, 2 kParts): the fill so far) and
// writes the runs out contiguously; which block's run comes first in a
// bucket is their race, which the inserts do not depend on.
// counters[2 kParts] receives the live rows in all.
__global__ void part_scatter_kernel(const long long* __restrict__ hash,
                                    const bool* __restrict__ live,
                                    long long n, uint32_t mask, int shift,
                                    int* __restrict__ counters,
                                    long long* __restrict__ part_hash,
                                    int* __restrict__ part_row) {
  extern __shared__ long long stage_h[];  // kPartRows, then the rows
  int* stage_r = reinterpret_cast<int*>(stage_h + kPartRows);
  __shared__ int buf[kThreads];
  __shared__ int hist[kParts];
  __shared__ int local[kParts];   // a bucket's first staged position
  __shared__ int run_at[kParts];  // its run's first global position
  const int p = threadIdx.x;
  Tile t;
  load_tile(hash, live, n, t);
  const int total = counters[p];
  const int start = block_exclusive(total, buf);
  if (blockIdx.x == 0 && p == kParts - 1) counters[2 * kParts] = start + total;
  hist[p] = 0;
  __syncthreads();
  int rank[kPartItems];
#pragma unroll
  for (int j = 0; j < kPartItems; ++j) {
    rank[j] = t.live[j] ? atomicAdd(&hist[bucket_of(t.h[j], mask, shift)], 1)
                        : 0;
  }
  __syncthreads();
  const int c = hist[p];
  local[p] = block_exclusive(c, buf);
  run_at[p] = c ? start + atomicAdd(&counters[kParts + p], c) : 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kPartRows + p;
#pragma unroll
  for (int j = 0; j < kPartItems; ++j) {
    if (t.live[j]) {
      const int at = local[bucket_of(t.h[j], mask, shift)] + rank[j];
      stage_h[at] = t.h[j];
      stage_r[at] = static_cast<int>(base + j * kThreads);
    }
  }
  __syncthreads();
  const int staged = local[kParts - 1] + hist[kParts - 1];
  for (int j = p; j < staged; j += kThreads) {
    const long long h = stage_h[j];
    const int b = bucket_of(h, mask, shift);
    const int at = run_at[b] + j - local[b];
    part_hash[at] = h;
    part_row[at] = stage_r[j];
  }
}

__global__ void build_part_kernel(const long long* __restrict__ part_hash,
                                  const int* __restrict__ part_row,
                                  const int* __restrict__ counters,
                                  pt::Slot* __restrict__ table,
                                  uint32_t mask, int max_probes,
                                  int* __restrict__ ok) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= counters[2 * kParts]) return;
  insert(table, mask, max_probes,
         static_cast<unsigned long long>(part_hash[i]), part_row[i], ok);
}

// One probe row a thread.
__global__ void __launch_bounds__(kThreads)
    probe_table_kernel(const pt::Slot* __restrict__ table, uint32_t mask,
                       const unsigned long long* __restrict__ hash,
                       const bool* __restrict__ live, long long n,
                       int max_probes, int* __restrict__ build_row,
                       bool* __restrict__ found, int* __restrict__ ok) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int row = -1;
  bool hit = false;
  if (live[i]) hit = pt::probe(table, mask, max_probes, hash[i], row, ok);
  build_row[i] = row;
  found[i] = hit;
}

}  // namespace

// table (cap slots of 16 bytes, all ones) and ok (1, set to 1) are
// initialised by the caller; cap is a power of two. With part_hash
// null the rows insert straight from their order; otherwise (cap of
// at least 1 << kPartBits) they are partitioned by home slot first,
// through part_hash and part_row (n entries each) and counters
// (pt_build_part_counters() ints, zero). Returns cudaGetLastError().
extern "C" int pt_build_table(const long long* hash, const bool* live,
                              long long n, pt::Slot* table, long long cap,
                              int max_probes, int* ok, long long* part_hash,
                              int* part_row, int* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t mask = static_cast<uint32_t>(cap - 1);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (part_hash == nullptr) {
    build_table_kernel<<<blocks, kThreads, 0, s>>>(hash, live, n, table,
                                                    mask, max_probes, ok);
    return static_cast<int>(cudaGetLastError());
  }
  if (cap < kParts) return static_cast<int>(cudaErrorInvalidValue);
  int shift = 0;
  while ((1ll << (shift + kPartBits)) < cap) ++shift;
  const unsigned part_blocks =
      static_cast<unsigned>((n + kPartRows - 1) / kPartRows);
  static const cudaError_t staged = cudaFuncSetAttribute(
      part_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStageBytes);
  if (staged != cudaSuccess) return static_cast<int>(staged);
  part_count_kernel<<<part_blocks, kThreads, 0, s>>>(hash, live, n, mask,
                                                      shift, counters);
  part_scatter_kernel<<<part_blocks, kThreads, kStageBytes, s>>>(
      hash, live, n, mask, shift, counters, part_hash, part_row);
  build_part_kernel<<<blocks, kThreads, 0, s>>>(part_hash, part_row,
                                                 counters, table, mask,
                                                 max_probes, ok);
  return static_cast<int>(cudaGetLastError());
}

// The ints of a partitioned build's counters.
extern "C" int pt_build_part_counters() { return 2 * kParts + 1; }

// ok (1, set to 1) is initialised by the caller.
extern "C" int pt_probe_table(const pt::Slot* table, long long cap,
                              const unsigned long long* hash,
                              const bool* live, long long n, int max_probes,
                              int* build_row, bool* found, int* ok,
                              void* stream) {
  if (n > 0) {
    probe_table_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        table, static_cast<uint32_t>(cap - 1), hash, live, n, max_probes,
        build_row, found, ok);
  }
  return static_cast<int>(cudaGetLastError());
}
