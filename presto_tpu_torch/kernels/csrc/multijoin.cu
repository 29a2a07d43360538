// multijoin_walk: the whole MultiJoin star chain in one pass over the
// spine.
//
// Replaces: try_fused (presto_tpu/kernels/multijoin.py:59), the TPU
// kernel that walks a VMEM-resident spine tile through every step's
// table with the hashes split into uint32 limbs, and declines when a
// table does not fit in VMEM.
//
// Bound on this card: bytes, and dependent random loads. Per spine
// row it reads the live flag and, per step, the key hashes (a spine
// column, or a build column gathered at an earlier step's match) and
// one or a few table slots; it writes one int32 gather per step and
// the live flag. Tables above the 50 MB L2 are served from HBM, one
// DRAM sector round trip per first slot touched.
//
// Design: one thread per spine row walks all k steps. The kernel is a
// template on k, so the step loop unrolls and the k matched rows are
// registers: a key chained from an earlier step picks its row with a
// select over the steps before it, known at compile time, and the walk
// has no stack frame (the first port indexed an array by the runtime
// source and kept it in 32 bytes of local memory). The step
// descriptors (table, slot mask, key count, per key its source, hash
// column and validity column) come by value as one __grid_constant__
// parameter, so every descriptor word is a uniform constant-bank read,
// and the host makes no device copy of them (a blocking copy from
// pageable memory, which waited for the stream to drain before every
// fused walk). Per step a thread combines its key hashes with the
// multiply-xor and EMPTY remap of ops/hash.combine_hashes in native
// 64-bit arithmetic, then probes that step's table (built by the
// build_table kernel) as probe_table does (common.cuh). A dead row
// reads nothing and gathers build row 0, as the reference's
// clip(where(found, row, -1)) does. Value checks against 64-bit hash
// collisions stay outside the kernel, as in the reference.
#include <stddef.h>

#include "common.cuh"

namespace pt {

constexpr int kMaxSteps = 8;
constexpr int kMaxKeys = 4;

// One probe key: source -1 = the spine, else the build step whose
// matched row indexes the key's column; valid may be null.
struct MjKey {
  long long source;
  const unsigned long long* hash;
  const bool* valid;
};

struct MjStep {
  const Slot* table;
  long long mask;
  long long nkeys;
  MjKey keys[kMaxKeys];
};

// The kernel parameter: 960 bytes, under the 4 KB parameter limit. The
// host packs it as a ctypes.Structure (kernels/build.py), checked
// against pt_multijoin_layout at load.
struct MjDesc {
  MjStep steps[kMaxSteps];
};

static_assert(sizeof(MjDesc) == kMaxSteps * (3 + 3 * kMaxKeys) * 8,
              "15 words a step");

}  // namespace pt

namespace {

using pt::kMaxKeys;
using pt::kMaxSteps;
using pt::MjDesc;
using pt::MjKey;
using pt::MjStep;

constexpr int kThreads = 256;

// g[src] for a source among the steps before S, else row 0: a select
// over registers, since S and K are known at compile time.
template <int K>
__device__ __forceinline__ int pick(const int (&g)[K], int S,
                                    long long src) {
  int row = 0;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    if (t < S && t == src) row = g[t];
  }
  return row;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    multijoin_walk_kernel(const __grid_constant__ MjDesc desc,
                          const bool* __restrict__ spine_live,
                          long long width, int max_probes,
                          int* __restrict__ gathers,
                          bool* __restrict__ alive_out,
                          int* __restrict__ ok) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= width) return;
  bool alive = spine_live[i];
  int g[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const MjStep& st = desc.steps[s];
    bool on = alive;
    unsigned long long h = 0ull;
#pragma unroll
    for (int q = 0; q < kMaxKeys; ++q) {
      if (q >= st.nkeys || !on) break;
      const MjKey& key = st.keys[q];
      // the spine's own column, or an earlier build's column at that
      // step's match
      const long long at = key.source < 0 ? i : pick<K>(g, s, key.source);
      if (key.valid != nullptr && !key.valid[at]) {
        on = false;
      } else {
        const unsigned long long kh = key.hash[at];
        h = q == 0 ? kh : (h * pt::kPhi64) ^ kh;
      }
    }
    if (h == pt::kEmpty) h -= 1ull;  // combine_hashes' remap
    int row = 0;
    bool hit = false;
    if (on) {
      int r = 0;
      hit = pt::probe(st.table, static_cast<uint32_t>(st.mask), max_probes,
                      h, r, ok);
      if (hit) row = r;
    }
    g[s] = row;
    alive = hit;
    gathers[s * width + i] = row;
  }
  alive_out[i] = alive;
}

template <int K>
void launch_walk(const MjDesc& desc, const bool* spine_live, long long width,
                 int max_probes, int* gathers, bool* alive, int* ok,
                 cudaStream_t s) {
  multijoin_walk_kernel<K>
      <<<static_cast<unsigned>((width + kThreads - 1) / kThreads), kThreads,
         0, s>>>(desc, spine_live, width, max_probes, gathers, alive, ok);
}

}  // namespace

// desc: the host's descriptor struct (its first k steps are read,
// and passed to the kernel by value); gathers: k * width int32; ok (1,
// set to 1) is initialised by the caller. Returns cudaGetLastError().
extern "C" int pt_multijoin_walk(const pt::MjDesc* desc, int k,
                                 const bool* spine_live, long long width,
                                 int max_probes, int* gathers, bool* alive,
                                 int* ok, void* stream) {
  if (k < 1 || k > kMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
  if (width > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    using Launch = void (*)(const MjDesc&, const bool*, long long, int,
                            int*, bool*, int*, cudaStream_t);
    static constexpr Launch kLaunch[kMaxSteps] = {
        launch_walk<1>, launch_walk<2>, launch_walk<3>, launch_walk<4>,
        launch_walk<5>, launch_walk<6>, launch_walk<7>, launch_walk<8>};
    kLaunch[k - 1](*desc, spine_live, width, max_probes, gathers, alive, ok,
                   s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The descriptor layout, for the host's check at load: the limits,
// then the sizes and field offsets of MjDesc, MjStep and MjKey.
// Returns the count of values written (at most n).
extern "C" int pt_multijoin_layout(long long* out, int n) {
  const long long v[] = {kMaxSteps,
                         kMaxKeys,
                         sizeof(MjDesc),
                         sizeof(MjStep),
                         offsetof(MjStep, table),
                         offsetof(MjStep, mask),
                         offsetof(MjStep, nkeys),
                         offsetof(MjStep, keys),
                         sizeof(MjKey),
                         offsetof(MjKey, source),
                         offsetof(MjKey, hash),
                         offsetof(MjKey, valid)};
  const int count = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < count && i < n; ++i) out[i] = v[i];
  return count;
}
