// filter_compact: a stable dense write of the live rows of several
// columns into `capacity` rows; live rows past `capacity` drop.
//
// Replaces: filter_compact_pallas (presto_tpu/kernels/compact.py:84),
// the TPU kernel that walks 256-row tiles in a sequential grid and
// appends each live row at a running count kept in VMEM; the count is
// race-free only because that grid runs in order, and the kernel
// declines past 8 MB of output (PALLAS_MAX_OUT_BYTES).
//
// Bound on this card: bytes. The live mask is read once, each live
// row's bytes are read once and `capacity` rows are written (the
// wrapper's zero fill included); a handful of integer operations a
// row, far below the integer rate.
//
// Design: Hopper's blocks run in no order, so each live row's output
// position comes from a scan instead of a running count, in three
// launches on one stream:
//   1. count_kernel: per tile of kTile rows, its live count;
//   2. scan_kernel: one block turns the counts into exclusive tile
//      offsets (int64);
//   3. scatter_kernel: each tile scans its own mask again (a
//      per-thread count over kItems consecutive rows, then a block
//      scan of those), adds its offset, and every live row whose
//      position is below `capacity` copies each column's row bytes
//      there.
// Rows keep their order, so a live row lands where the reference puts
// it. The columns come in one small int64 descriptor array (source
// pointer, destination pointer, bytes per row), as multijoin.cu takes
// its step descriptors: a [n, 2] long-decimal column copies 16 bytes a
// row. The kernels allocate nothing; the wrapper gives zeroed outputs
// and the count/offset scratch.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // consecutive rows per thread
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;
constexpr int kDescWords = 3;  // src, dst, bytes per row

// Exclusive scan of one int64 per thread across the block; returns the
// block total through *total. Needs blockDim.x / 32 words of shared.
__device__ long long block_exclusive_scan(long long v, long long* warp_sums,
                                          long long* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  long long inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(0xFFFFFFFFu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < nwarps ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(0xFFFFFFFFu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < nwarps) warp_sums[lane] = w;  // inclusive warp prefix
  }
  __syncthreads();
  const long long before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the caller's next scan
  return before + inc - v;
}

__global__ void count_kernel(const bool* __restrict__ live, long long n,
                             int* __restrict__ counts) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  int c = 0;
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j;
    if (i < n && live[i]) ++c;
  }
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_down_sync(0xFFFFFFFFu, c, off);
  }
  __shared__ int warp_counts[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kThreads / 32; ++w) t += warp_counts[w];
    counts[blockIdx.x] = t;
  }
}

// one block: exclusive offsets of the tile counts, in chunks of
// kScanThreads with a running carry
__global__ void scan_kernel(const int* __restrict__ counts, int ntiles,
                            long long* __restrict__ offsets) {
  __shared__ long long warp_sums[kScanThreads / 32];
  long long carry = 0;
  for (int start = 0; start < ntiles; start += kScanThreads) {
    const int t = start + threadIdx.x;
    const long long v = t < ntiles ? counts[t] : 0;
    long long total;
    const long long ex = block_exclusive_scan(v, warp_sums, &total);
    if (t < ntiles) offsets[t] = carry + ex;
    carry += total;
  }
}

__device__ __forceinline__ void copy_row(const char* __restrict__ src,
                                         char* __restrict__ dst,
                                         long long row_bytes, long long i,
                                         long long pos) {
  const char* s = src + i * row_bytes;
  char* d = dst + pos * row_bytes;
  switch (row_bytes) {
    case 1: *d = *s; break;
    case 2:
      *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s);
      break;
    case 4:
      *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
      break;
    case 8:
      *reinterpret_cast<uint64_t*>(d) = *reinterpret_cast<const uint64_t*>(s);
      break;
    case 16:
      reinterpret_cast<uint64_t*>(d)[0] = reinterpret_cast<const uint64_t*>(s)[0];
      reinterpret_cast<uint64_t*>(d)[1] = reinterpret_cast<const uint64_t*>(s)[1];
      break;
    default:
      for (long long b = 0; b < row_bytes; ++b) d[b] = s[b];
  }
}

__global__ void scatter_kernel(const bool* __restrict__ live, long long n,
                               const long long* __restrict__ offsets,
                               const long long* __restrict__ desc, int ncols,
                               long long capacity) {
  __shared__ long long warp_sums[kThreads / 32];
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  unsigned mask = 0u;
  int c = 0;
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j;
    if (i < n && live[i]) {
      mask |= 1u << j;
      ++c;
    }
  }
  long long total;
  long long pos = offsets[blockIdx.x] + block_exclusive_scan(c, warp_sums,
                                                             &total);
  for (int j = 0; j < kItems && pos < capacity; ++j) {
    if (!(mask & (1u << j))) continue;
    for (int col = 0; col < ncols; ++col) {
      const long long* dc = desc + col * kDescWords;
      copy_row(reinterpret_cast<const char*>(dc[0]),
               reinterpret_cast<char*>(dc[1]), dc[2], base + j, pos);
    }
    ++pos;
  }
}

}  // namespace

// Rows per tile: the wrapper sizes the scratch with it.
extern "C" int pt_compact_tile_rows() { return kTile; }

// Scratch: counts int32 [ntiles], offsets int64 [ntiles], ntiles =
// ceil(n / pt_compact_tile_rows()). desc: int64 [ncols * 3] on the
// device. The outputs hold zeros on entry. Returns cudaGetLastError()
// after the three launches.
extern "C" int pt_filter_compact(const bool* live, long long n,
                                 const long long* desc, int ncols,
                                 long long capacity, int* counts,
                                 long long* offsets, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ntiles = (n + kTile - 1) / kTile;
  if (ntiles <= 0) return 0;
  if (ntiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(ntiles);
  count_kernel<<<grid, kThreads, 0, s>>>(live, n, counts);
  scan_kernel<<<1, kScanThreads, 0, s>>>(counts, grid, offsets);
  scatter_kernel<<<grid, kThreads, 0, s>>>(live, n, offsets, desc, ncols,
                                           capacity);
  return static_cast<int>(cudaGetLastError());
}
