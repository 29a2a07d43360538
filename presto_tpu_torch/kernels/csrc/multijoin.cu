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
// the live flag. Tables above the 50 MB L2 are served from HBM.
//
// Design: one thread per spine row walks all k steps. Per step it
// combines the step's column hashes with the multiply-xor and EMPTY
// remap of ops/hash.combine_hashes in native 64-bit arithmetic, probes
// that step's table (built by the build_table kernel) with linear
// probing, and keeps the k matched build rows in registers, so a later
// step's key can come from an earlier step's build. A dead row reads
// nothing and gathers build row 0, as the reference's
// clip(where(found, row, -1)) does. Step descriptors (table pointers,
// masks, key sources) come in one small device array of int64 words.
// Value checks against 64-bit hash collisions stay outside the kernel,
// as in the reference.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSteps = 8;
constexpr int kMaxKeys = 4;
// descriptor words per step: keys ptr, rows ptr, mask, nkeys, then per
// key (source, hash ptr, valid ptr); source -1 = spine, else the build
// step whose matched row indexes the key column
constexpr int kStepWords = 4 + 3 * kMaxKeys;

__global__ void multijoin_walk_kernel(const long long* __restrict__ desc,
                                      int k,
                                      const bool* __restrict__ spine_live,
                                      long long width, int max_probes,
                                      int* __restrict__ gathers,
                                      bool* __restrict__ alive_out,
                                      int* __restrict__ ok) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= width) return;
  int g[kMaxSteps];
  bool alive = spine_live[i];
  for (int s = 0; s < k; ++s) {
    const long long* d = desc + s * kStepWords;
    int row = 0;
    bool found = false;
    if (alive) {
      const int nkeys = static_cast<int>(d[3]);
      bool kv = true;
      unsigned long long h = 0ull;
      for (int j = 0; j < nkeys; ++j) {
        const long long src = d[4 + 3 * j];
        const long long idx = src < 0 ? i : g[src];
        const bool* valid = reinterpret_cast<const bool*>(d[6 + 3 * j]);
        if (valid != nullptr) kv = kv && valid[idx];
        const unsigned long long kh =
            reinterpret_cast<const unsigned long long*>(d[5 + 3 * j])[idx];
        h = j == 0 ? kh : (h * pt::kPhi64) ^ kh;
      }
      if (h == pt::kEmpty) h -= 1ull;  // combine_hashes' remap
      if (kv) {
        const unsigned long long* keys =
            reinterpret_cast<const unsigned long long*>(d[0]);
        const int* rows = reinterpret_cast<const int*>(d[1]);
        const uint32_t mask = static_cast<uint32_t>(d[2]);
        uint32_t slot = pt::slot32(h) & mask;
        bool decided = false;
        for (int j = 0; j < max_probes; ++j) {
          const unsigned long long t = keys[slot];
          if (t == h) {
            row = rows[slot];
            found = true;
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
    }
    g[s] = row;
    gathers[s * width + i] = row;
    alive = found;
  }
  alive_out[i] = alive;
}

}  // namespace

// desc: k * kStepWords int64 words on the device; gathers: k * width
// int32; ok (1, set to 1) is initialised by the caller. Returns
// cudaGetLastError().
extern "C" int pt_multijoin_walk(const long long* desc, int k,
                                 const bool* spine_live, long long width,
                                 int max_probes, int* gathers, bool* alive,
                                 int* ok, void* stream) {
  if (k < 1 || k > kMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
  if (width > 0) {
    const long long blocks = (width + kThreads - 1) / kThreads;
    multijoin_walk_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        desc, k, spine_live, width, max_probes, gathers, alive, ok);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_multijoin_limits(int* max_steps, int* max_keys,
                                   int* step_words) {
  *max_steps = kMaxSteps;
  *max_keys = kMaxKeys;
  *step_words = kStepWords;
  return 0;
}
