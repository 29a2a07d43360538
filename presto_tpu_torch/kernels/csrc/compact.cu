// filter_compact: a stable dense write of the live rows of several
// columns into `capacity` rows; live rows past `capacity` drop, and
// rows past the live count are zero.
//
// Replaces: filter_compact_pallas (presto_tpu/kernels/compact.py:84),
// the TPU kernel that walks 256-row tiles in a sequential grid and
// appends each live row at a running count kept in VMEM; the count is
// race-free only because that grid runs in order, and the kernel
// declines past 8 MB of output (PALLAS_MAX_OUT_BYTES).
//
// Bound on this card: bytes. The live mask is read once, each live
// row's bytes are read once and `capacity` rows are written; a handful
// of integer operations a row, far below the integer rate. A sparse
// mask makes the reads costlier than their bytes: each live row costs
// whole 32-byte sectors of every column at random places, which a
// gather of the same rows (index_select at the live indices) pays too.
// That gather and the zeroed tail alone take 0.37 ms for a 60M-row
// mask, 4% live, into 2^23 rows of 33 bytes (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py's gather floor), three times the byte bound;
// this kernel takes 1.0-1.1x that floor.
//
// Design: Hopper's blocks run in no order, so each live row's output
// position comes from a scan instead of a running count: a single pass
// with decoupled look-back (Merrill and Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016). A tile is kTile rows,
// 64 a thread read as four 16-byte loads of the mask. Tiles take their
// index from an atomic counter, so every tile a tile waits on has
// started and never waits in turn on a later one. Each tile counts its
// live rows (a block scan of per-thread popcounts), stages their row
// numbers in shared memory in order, publishes its count with a flag
// in one 64-bit status word, then has one warp look back over the
// status words of the tiles before it, 32 at a time, summing counts
// until it meets a tile that has published its inclusive prefix, and
// publishes its own. Then, column by column, consecutive threads write
// consecutive output rows (or consecutive words of them), with the
// widest word (up to 16 bytes) that the row width and both addresses
// allow, so a warp's stores are dense. Rows keep their order, so a
// live row lands where the reference puts it. The columns come by value
// as one __grid_constant__ parameter (CompactDesc, at most
// kCompactMaxCols columns; the host packs it as a ctypes.Structure in
// kernels/build.py, checked against pt_compact_layout at load), so the
// host copies nothing to the device. More columns go through further
// launches that reuse the published prefixes instead of scanning
// again. The outputs are not zeroed by the wrapper: after each launch,
// a tail launch reads the live total that the last tile stored and
// zeroes rows [total, capacity) only.
#include <stddef.h>

#include "common.cuh"

namespace pt {

constexpr int kCompactMaxCols = 32;

// One column: its rows' bytes at src, the output rows at dst.
struct CompactCol {
  const char* src;
  char* dst;
  long long row_bytes;
};

// The kernel parameter: 776 bytes, under the 4 KB parameter limit.
struct CompactDesc {
  long long ncols;
  CompactCol cols[kCompactMaxCols];
};

static_assert(sizeof(CompactDesc) == 8 + kCompactMaxCols * 24,
              "three words a column");

}  // namespace pt

namespace {

using pt::CompactCol;
using pt::CompactDesc;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;            // 16-byte loads of the mask a thread
constexpr int kRowsPerThread = 16 * kLoads;
constexpr int kTile = kThreads * kRowsPerThread;
constexpr int kBatch = 4;            // row loads in flight a thread

// A tile's status word: a flag in the top two bits, a count below.
constexpr unsigned long long kAggregate = 1ull << 62;  // its own count
constexpr unsigned long long kPrefix = 1ull << 63;     // inclusive prefix
constexpr unsigned long long kCount = kAggregate - 1;

// Scratch words (int64, zero on entry to the scanning launch): the tile
// counter, the live total, then one status word per tile.
constexpr int kCounterWord = 0;
constexpr int kTotalWord = 1;
constexpr int kStatusWord = 2;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Bit j set when byte j of the 16 is nonzero.
__device__ __forceinline__ unsigned live_bits(uint4 w) {
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned x = words[q];
    x |= x >> 4;
    x |= x >> 2;
    x |= x >> 1;
    x &= 0x01010101u;  // bit 0 of each byte: the byte is nonzero
    m |= ((x * 0x01020408u) >> 24) << (4 * q);  // the four bits in order
  }
  return m;
}

// The live bits of rows [r, r + kRowsPerThread): aligned 16-byte
// loads where all the rows are rows of the mask, else byte loads of
// those that are.
__device__ __forceinline__ unsigned long long load_live(
    const bool* __restrict__ live, long long n, long long r) {
  unsigned long long m = 0;
  if (r >= 0 && r + kRowsPerThread <= n) {
    const uint4* q = reinterpret_cast<const uint4*>(live + r);
    uint4 w[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) w[j] = __ldg(q + j);
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      m |= static_cast<unsigned long long>(live_bits(w[j])) << (16 * j);
    }
    return m;
  }
  for (int j = 0; j < kRowsPerThread; ++j) {
    const long long i = r + j;
    if (i >= 0 && i < n && live[i]) m |= 1ull << j;
  }
  return m;
}

// Exclusive block scan of one count a thread; *total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0;
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    sum += s;
  }
  *total = sum;
  return before + inc - v;
}

// One warp: the count of live rows before `tile`, from the status
// words of the tiles before it (waiting for each to publish at least
// its own count). Lane l reads tile - 1 - l, then 32 further back.
__device__ long long look_back(const unsigned long long* status,
                               long long tile) {
  const int lane = threadIdx.x & 31;
  long long before = 0;
  for (long long at = tile - 1 - lane;; at -= 32) {
    unsigned long long st = kPrefix;  // before tile 0: a prefix of 0
    if (at >= 0) {
      do {
        st = load_status(status + at);
      } while ((st & (kAggregate | kPrefix)) == 0);
    }
    const unsigned prefixed = __ballot_sync(0xFFFFFFFFu, (st & kPrefix) != 0);
    // the nearest tile with its prefix is the lowest lane that has one
    const int stop = prefixed ? __ffs(prefixed) - 1 : 31;
    long long v = lane <= stop ? static_cast<long long>(st & kCount) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    before += v;
    if (prefixed) return before;
  }
}

// Output rows [pos0, pos0 + m) of one column from tile rows rows[0..m)
// (source row row0 + rows[p]), in words of W: consecutive threads take
// consecutive words, kBatch loads in flight before their stores.
template <typename W>
__device__ __forceinline__ void copy_rows(const CompactCol& c,
                                          const unsigned short* rows, int m,
                                          long long row0, long long pos0) {
  const W* __restrict__ src = reinterpret_cast<const W*>(c.src);
  W* __restrict__ dst = reinterpret_cast<W*>(c.dst);
  const int nw = static_cast<int>(c.row_bytes / sizeof(W));
  const int words = m * nw;
  for (int q0 = threadIdx.x; q0 < words; q0 += kBatch * kThreads) {
    W v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + u * kThreads;
      if (q < words) {
        const int p = nw == 1 ? q : q / nw;
        v[u] = __ldg(src + (row0 + rows[p]) * nw + (q - p * nw));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + u * kThreads;
      if (q < words) dst[pos0 * nw + q] = v[u];
    }
  }
}

// The widest word (1 to 16 bytes) dividing the row width and both
// addresses.
__device__ __forceinline__ int word_bytes(const CompactCol& c) {
  const unsigned long long a =
      static_cast<unsigned long long>(c.row_bytes) |
      reinterpret_cast<unsigned long long>(c.src) |
      reinterpret_cast<unsigned long long>(c.dst) | 16ull;
  return static_cast<int>(a & (~a + 1ull));
}

template <bool kScan>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(const bool* __restrict__ live, long long n,
                   const __grid_constant__ CompactDesc desc,
                   long long capacity, long long ntiles,
                   unsigned long long* __restrict__ scratch) {
  __shared__ unsigned short rows[kTile];
  __shared__ int warp_sums[kWarps];
  __shared__ long long shared_word;  // the tile index, then its prefix
  unsigned long long* status = scratch + kStatusWord;
  long long tile = blockIdx.x;
  long long before = 0;  // live rows before this tile
  if (kScan) {
    if (threadIdx.x == 0) shared_word = atomicAdd(scratch + kCounterWord, 1ull);
    __syncthreads();
    tile = shared_word;
  } else {
    // the prefixes the scanning launch published
    before = tile == 0 ? 0 : static_cast<long long>(status[tile - 1] & kCount);
    if (before >= capacity) return;
  }
  // tile rows start at mask row `row0`, 16-byte aligned in memory
  const long long shift = reinterpret_cast<unsigned long long>(live) & 15;
  const long long row0 = tile * kTile - shift;
  const int local = threadIdx.x * kRowsPerThread;
  unsigned long long bits = load_live(live, n, row0 + local);
  int count = 0;
  int at = block_exclusive_scan(__popcll(bits), warp_sums, &count);
  for (; bits; bits &= bits - 1) {
    rows[at++] = static_cast<unsigned short>(local + __ffsll(bits) - 1);
  }
  if (kScan) {
    if (threadIdx.x < 32) {
      if (tile > 0) {
        if (threadIdx.x == 0) store_status(status + tile, kAggregate | count);
        before = look_back(status, tile);
      }
      if (threadIdx.x == 0) {
        store_status(status + tile, kPrefix | (before + count));
        if (tile == ntiles - 1) scratch[kTotalWord] = before + count;
        shared_word = before;
      }
    }
    __syncthreads();  // also publishes `rows`
    before = shared_word;
  } else {
    __syncthreads();
  }
  const long long room = capacity - before;
  const int m = static_cast<int>(room < count ? (room > 0 ? room : 0) : count);
  if (m == 0) return;
  for (int col = 0; col < desc.ncols; ++col) {
    const CompactCol& c = desc.cols[col];
    switch (word_bytes(c)) {
      case 16: copy_rows<uint4>(c, rows, m, row0, before); break;
      case 8: copy_rows<uint2>(c, rows, m, row0, before); break;
      case 4: copy_rows<unsigned>(c, rows, m, row0, before); break;
      case 2: copy_rows<unsigned short>(c, rows, m, row0, before); break;
      default: copy_rows<unsigned char>(c, rows, m, row0, before);
    }
  }
}

// Zeroes output rows [total, capacity) of column blockIdx.y: 16-byte
// stores over the aligned middle, byte stores at the two edges.
__global__ void __launch_bounds__(kThreads)
    zero_tail_kernel(const __grid_constant__ CompactDesc desc,
                     long long capacity,
                     const unsigned long long* __restrict__ scratch) {
  const long long total = static_cast<long long>(scratch[kTotalWord]);
  if (total >= capacity) return;
  const CompactCol& c = desc.cols[blockIdx.y];
  const unsigned long long base = reinterpret_cast<unsigned long long>(c.dst);
  const unsigned long long lo = base + total * c.row_bytes;
  const unsigned long long hi = base + capacity * c.row_bytes;
  const unsigned long long up = (lo + 15) & ~15ull;
  const unsigned long long w0 = up < hi ? up : hi;
  const unsigned long long down = hi & ~15ull;
  const unsigned long long w1 = down > w0 ? down : w0;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if (tid < static_cast<long long>(w0 - lo)) {
    reinterpret_cast<char*>(lo)[tid] = 0;
  }
  if (tid < static_cast<long long>(hi - w1)) {
    reinterpret_cast<char*>(w1)[tid] = 0;
  }
  uint4* words = reinterpret_cast<uint4*>(w0);
  const long long nwords = static_cast<long long>(w1 - w0) / 16;
  for (long long i = tid; i < nwords; i += stride) {
    words[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

}  // namespace

// Rows per tile: the wrapper sizes the scratch with it.
extern "C" int pt_compact_tile_rows() { return kTile; }

// desc: the host's descriptor struct (its first ncols columns are
// copied, passed to the kernels by value). scratch: int64, at least
// 2 + n / pt_compact_tile_rows() + 2 words, zero before the scanning
// launch (scan = 1), which publishes every tile's prefix and the live
// total there; a launch with scan = 0 reuses them for further columns.
// Each call then zeroes rows [total, capacity) of its columns. Returns
// cudaGetLastError() after the two launches.
extern "C" int pt_filter_compact(const bool* live, long long n,
                                 const CompactDesc* desc, long long capacity,
                                 unsigned long long* scratch, int scan,
                                 void* stream) {
  if (desc->ncols < 1 || desc->ncols > pt::kCompactMaxCols || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long shift = reinterpret_cast<unsigned long long>(live) & 15;
  const long long ntiles = (n + shift + kTile - 1) / kTile;
  if (ntiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(ntiles);
  if (scan) {
    compact_kernel<true><<<grid, kThreads, 0, s>>>(live, n, *desc, capacity,
                                                   ntiles, scratch);
  } else {
    compact_kernel<false><<<grid, kThreads, 0, s>>>(live, n, *desc, capacity,
                                                    ntiles, scratch);
  }
  long long widest = 1;
  for (long long c = 0; c < desc->ncols; ++c) {
    if (desc->cols[c].row_bytes > widest) widest = desc->cols[c].row_bytes;
  }
  const dim3 tail(pt::grid_for((capacity * widest + 15) / 16, kThreads, 1024),
                  static_cast<unsigned>(desc->ncols));
  zero_tail_kernel<<<tail, kThreads, 0, s>>>(*desc, capacity, scratch);
  return static_cast<int>(cudaGetLastError());
}

// The descriptor layout, for the host's check at load: the column
// limit, then the sizes and field offsets of CompactDesc and
// CompactCol. Returns the count of values written (at most n).
extern "C" int pt_compact_layout(long long* out, int n) {
  const long long v[] = {pt::kCompactMaxCols,
                         sizeof(CompactDesc),
                         offsetof(CompactDesc, ncols),
                         offsetof(CompactDesc, cols),
                         sizeof(CompactCol),
                         offsetof(CompactCol, src),
                         offsetof(CompactCol, dst),
                         offsetof(CompactCol, row_bytes)};
  const int count = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < count && i < n; ++i) out[i] = v[i];
  return count;
}
