// The tree LFU and FTPL: one chunk of requests, in order, in one launch.
//
// The reference has no Pallas kernel here: it scans each automaton's
// per-request step over the chunk with lax.scan
// (src/repro/cachesim/tree_engines.py: make_lfu_tree_chunk,
// make_ftpl_tree_chunk), its victim search a lexicographic (hi, lo) min-tree
// over the slots at radix 64 (src/repro/kernels/prefix_tree/ops.py,
// minpair_*).  The port's plain version is ../ref.py's minpair_automaton_ref.
// This kernel computes the same, bit for bit: the hits, and the carry (imap,
// its scratch entry imap[N], counts, slots, both trees, LFU's clock).
//
// A slot's key is (frequency, tick) for LFU, empty slots (-1, -1); for FTPL
// (sortable score, item id), the score float32(count) + noise, one float32
// add (__fadd_rn: no contraction); inactive slots (INT32_MAX, INT32_MAX).  A
// tree node holds the least pair of its 64 children; the root is the least
// pair of the top level, and the argmin leaf is found by descending to the
// first child that holds its parent's pair (the first index wins ties, as
// the reference's group argmins do).
//
// Where the tree lives.  At C = 50 000 the leaves (two int32 arrays of
// 200 KB) do not fit one block's shared memory beside anything else; the
// ~800 nodes above them do.  So the levels above the leaves sit in shared
// memory for the whole chunk (written back at its end), and the leaves,
// slots, imap and counts stay in global memory, where they stay in L2.
//
// The requests are walked by one warp, in tiles of 32: each lane loads one
// request's id, imap entry and count (and FTPL's noise), and finds its rank
// among the tile's equal ids, so the count after the request is the count
// before the tile plus rank + 1 and the tile's reads are in flight together;
// the last occurrence of an id writes its count back after the tile.  A
// lane keeps its request's imap entry current through the tile: each write
// to imap is broadcast, and the lanes whose id it names take it.  Then per
// request:
//  1. a hit (imap[j] >= 0) takes its slot; a miss reduces the top level to
//     the root and descends, one warp-wide reduction of 64 children a level
//     (two a lane; redux.sync min over the hi word, over the lo word among
//     the least hi, over the index among the least pairs), the last over the
//     leaves and their slots read from L2;
//  2. LFU admits when hit or f >= root hi, FTPL swaps when it misses and its
//     hi is strictly above the root's;
//  3. the leaf is written, and its ancestors are recomputed from their
//     groups with the new child substituted, stopping where a node keeps
//     its pair; slots and imap take the newcomer and drop the evicted item.
//
// Bound on an H100: bytes (the ids, the touched imap, counts and noise
// entries, each written entry and the tree nodes on the touched paths)
// take well under a microsecond at a 10 000-request chunk; the kernel is
// latency-bound, a chain of dependent requests, each a few dependent
// warp-wide reductions and, on a miss, one group of leaves read from L2.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kLFU = 0, kFTPL = 1;
constexpr int kShift = 6;  // radix 64
constexpr int kRadix = 1 << kShift;
constexpr int kThreads = 256;  // the bulk copies; one warp runs the automaton
constexpr int kMaxLevels = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  long long off[kMaxLevels];
  int size[kMaxLevels];
  int count;
};

struct Pair {
  int h, l, i;
};

// A group of 64 children, two a lane (children base + lane and base + lane
// + 32), with their slots where the children are leaves.  Children past the
// level's end read as (INT32_MAX, INT32_MAX) at index INT32_MAX.
struct Group {
  int base;
  int h0, l0, i0, s0;
  int h1, l1, i1, s1;
};

__device__ __forceinline__ int sortable(float x) {
  const int b = __float_as_int(__fadd_rn(x, 0.0f));
  return b < 0 ? b ^ 0x7fffffff : b;
}

template <bool kLeaves>
__device__ __forceinline__ Group load_group(const int* hi, const int* lo, const int* slots,
                                            int base, int size, int lane) {
  Group g;
  g.base = base;
  const int c0 = base + lane, c1 = c0 + 32;
  const bool v0 = c0 < size, v1 = c1 < size;
  if (kLeaves) {
    g.h0 = v0 ? __ldcg(hi + c0) : INT_MAX;
    g.l0 = v0 ? __ldcg(lo + c0) : INT_MAX;
    g.s0 = v0 ? __ldcg(slots + c0) : -2;
    g.h1 = v1 ? __ldcg(hi + c1) : INT_MAX;
    g.l1 = v1 ? __ldcg(lo + c1) : INT_MAX;
    g.s1 = v1 ? __ldcg(slots + c1) : -2;
  } else {
    g.h0 = v0 ? hi[c0] : INT_MAX;
    g.l0 = v0 ? lo[c0] : INT_MAX;
    g.h1 = v1 ? hi[c1] : INT_MAX;
    g.l1 = v1 ? lo[c1] : INT_MAX;
    g.s0 = g.s1 = -2;
  }
  g.i0 = v0 ? c0 : INT_MAX;
  g.i1 = v1 ? c1 : INT_MAX;
  return g;
}

// The group's least (hi, lo) and its first index, in every lane.
__device__ __forceinline__ Pair group_min(const Group& g) {
  const bool second = g.h1 < g.h0 || (g.h1 == g.h0 && g.l1 < g.l0);
  const int h = second ? g.h1 : g.h0;
  const int l = second ? g.l1 : g.l0;
  const int i = second ? g.i1 : g.i0;
  const int bh = __reduce_min_sync(kFull, h);
  const int bl = __reduce_min_sync(kFull, h == bh ? l : INT_MAX);
  const int bi = __reduce_min_sync(kFull, h == bh && l == bl ? i : INT_MAX);
  return {bh, bl, bi};
}

// Sets child `idx` of the group to (h, l) where a lane holds it.
__device__ __forceinline__ void substitute(Group& g, int idx, int h, int l) {
  if (g.i0 == idx) {
    g.h0 = h;
    g.l0 = l;
  }
  if (g.i1 == idx) {
    g.h1 = h;
    g.l1 = l;
  }
}

// The slot of child `idx` of a leaf group, in every lane.
__device__ __forceinline__ int slot_of(const Group& g, int idx) {
  const int v = idx - g.base;
  const int mine = v < 32 ? g.s0 : g.s1;
  return __shfl_sync(kFull, mine, v & 31);
}

template <int KIND>
__device__ void run_warp(int* __restrict__ imap, int* __restrict__ counts,
                         const float* __restrict__ noise, int* __restrict__ slots,
                         int* __restrict__ th, int* __restrict__ tl, int* s_hi, int* s_lo,
                         int* __restrict__ tclock, const int* __restrict__ ids, int window,
                         int n_items, const Levels& lv, unsigned char* __restrict__ flags,
                         int* __restrict__ hits_out) {
  const int lane = threadIdx.x;
  const int top = lv.count - 1;
  const int k_slots = lv.size[0];
  const long long up = lv.count > 1 ? lv.off[1] : 0;  // shared node x is tree node up + x
  const int t0 = KIND == kLFU ? *tclock : 0;
  int hits = 0, scratch = -1;

  for (int base = 0; base < window; base += 32) {
    const int n = min(32, window - base);
    int j = -1, mine = -1, f = 0, key = 0;
    if (lane < n) {
      j = __ldg(ids + base + lane);
      mine = __ldcg(imap + j);
      f = __ldcg(counts + j);
    }
    int rank = 0;
    bool final = true;
    for (int s = 0; s < n; ++s) {
      const int js = __shfl_sync(kFull, j, s);
      if (js == j) {
        rank += s < lane;
        final &= s <= lane;
      }
    }
    f += rank + 1;
    if (KIND == kFTPL && lane < n) key = sortable(__fadd_rn(__int2float_rn(f), __ldg(noise + j)));

    for (int q = 0; q < n; ++q) {
      const int jq = __shfl_sync(kFull, j, q);
      const int fq = __shfl_sync(kFull, f, q);
      const int slot = __shfl_sync(kFull, mine, q);
      const int nh = KIND == kLFU ? fq : __shfl_sync(kFull, key, q);
      const int nl = KIND == kLFU ? t0 + base + q : jq;
      const bool hit = slot >= 0;
      hits += hit;
      if (flags != nullptr && lane == 0) flags[base + q] = hit;

      int idx = slot;
      bool write = true;
      Group leaves;
      if (!hit) {
        // the root, then down to the first leaf that holds it
        Group g = top == 0 ? load_group<true>(th, tl, slots, 0, k_slots, lane)
                           : load_group<false>(s_hi + (lv.off[top] - up), s_lo + (lv.off[top] - up),
                                               nullptr, 0, lv.size[top], lane);
        const Pair root = group_min(g);
        int node = root.i;
        for (int l = top; l >= 1; --l) {
          const int cb = node << kShift;
          g = l == 1 ? load_group<true>(th, tl, slots, cb, k_slots, lane)
                     : load_group<false>(s_hi + (lv.off[l - 1] - up), s_lo + (lv.off[l - 1] - up),
                                         nullptr, cb, lv.size[l - 1], lane);
          node = group_min(g).i;
        }
        idx = node;
        leaves = g;
        write = KIND == kLFU ? nh >= root.h : nh > root.h;
        if (write) {
          const int old = slot_of(leaves, idx);
          if (lane == 0) {
            if (old >= 0) imap[old] = -1;
            imap[jq] = idx;
            slots[idx] = jq;
          }
          if (old >= 0 && j == old) mine = -1;
          if (j == jq) mine = idx;
          if (old < 0) scratch = -1;
        } else {
          scratch = idx;
        }
      } else {
        scratch = KIND == kLFU ? -1 : idx;
        leaves = load_group<true>(th, tl, slots, idx & ~(kRadix - 1), k_slots, lane);
      }
      if (write) {
        if (lane == 0) {
          th[idx] = nh;
          tl[idx] = nl;
        }
        substitute(leaves, idx, nh, nl);
        Group g = leaves;
        for (int l = 1; l <= top; ++l) {
          const Pair p = group_min(g);
          const int node = idx >> (kShift * l);
          int* sh = s_hi + (lv.off[l] - up) + node;
          int* sl = s_lo + (lv.off[l] - up) + node;
          if (*sh == p.h && *sl == p.l) break;  // the node keeps its pair: so do its ancestors
          __syncwarp();
          if (lane == 0) {
            *sh = p.h;
            *sl = p.l;
          }
          __syncwarp();
          if (l < top) {
            g = load_group<false>(s_hi + (lv.off[l] - up), s_lo + (lv.off[l] - up), nullptr,
                                  (node >> kShift) << kShift, lv.size[l], lane);
          }
        }
      }
      __syncwarp();
    }
    if (lane < n && final) counts[j] = f;
    __syncwarp();
  }
  if (lane == 0) {
    imap[n_items] = scratch;
    if (KIND == kLFU) *tclock = t0 + window;
    *hits_out = hits;
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
    minpair_kernel(int* __restrict__ imap, int* __restrict__ counts,
                   const float* __restrict__ noise, int* __restrict__ slots, int* __restrict__ th,
                   int* __restrict__ tl, int* __restrict__ tclock, const int* __restrict__ ids,
                   int window, int n_items, Levels lv, unsigned char* __restrict__ flags,
                   int* __restrict__ hits_out, float* __restrict__ stats) {
  extern __shared__ int smem[];
  __shared__ int s_occ;
  const long long up = lv.count > 1 ? lv.off[1] : 0;
  const int upper = lv.count > 1 ? (int)(lv.off[lv.count - 1] + lv.size[lv.count - 1] - up) : 0;
  int* s_hi = smem;
  int* s_lo = smem + upper;
  for (int x = threadIdx.x; x < upper; x += blockDim.x) {
    s_hi[x] = th[up + x];
    s_lo[x] = tl[up + x];
  }
  if (threadIdx.x == 0) s_occ = 0;
  __syncthreads();
  if (threadIdx.x < 32) {
    run_warp<KIND>(imap, counts, noise, slots, th, tl, s_hi, s_lo, tclock, ids, window, n_items,
                   lv, flags, hits_out);
  }
  __syncthreads();
  for (int x = threadIdx.x; x < upper; x += blockDim.x) {
    th[up + x] = s_hi[x];
    tl[up + x] = s_lo[x];
  }
  int occ = 0;
  for (int k = threadIdx.x; k < lv.size[0]; k += blockDim.x) occ += __ldcg(slots + k) >= 0;
  for (int o = 16; o > 0; o >>= 1) occ += __shfl_xor_sync(kFull, occ, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_occ, occ);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int hits = *hits_out;
    stats[0] = (float)hits;  // reward: the automata's reward is their hits
    stats[1] = 0.0f;         // aux: no threshold
    stats[2] = (float)s_occ;
  }
}

template <int KIND>
int launch(int window, const int* ids, int n_items, const Levels& lv, int* imap, int* counts,
           const float* noise, int* slots, int* th, int* tl, int* t, unsigned char* flags,
           int* hits, float* stats, cudaStream_t stream) {
  const long long up = lv.count > 1 ? lv.off[1] : 0;
  const long long upper = lv.count > 1 ? lv.off[lv.count - 1] + lv.size[lv.count - 1] - up : 0;
  const size_t smem = (size_t)(2 * upper) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        minpair_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  minpair_kernel<KIND><<<1, kThreads, smem, stream>>>(imap, counts, noise, slots, th, tl, t, ids,
                                                      window, n_items, lv, flags, hits, stats);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 lfu (t its int32 clock, noise null), 1 ftpl (noise (N,) float32,
// t null).  sizes: the min-tree's `count` level sizes, leaves first (the
// slot count).  imap holds N + 1 entries, counts N.  flags: null, or one byte
// a request.  hits: one int32; stats: three float32 (reward, aux, occupancy).
extern "C" int repro_minpair_automaton(int kind, int window, const void* ids, int n_items,
                                       int count, const long long* sizes, void* imap,
                                       void* counts, const void* noise, void* slots, void* th,
                                       void* tl, void* t, void* flags, void* hits, void* stats,
                                       void* stream) {
  if (count < 1 || count > kMaxLevels || window < 1 || n_items < 1 || sizes[0] < 1 ||
      sizes[count - 1] > kRadix) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv{};
  long long off = 0;
  for (int l = 0; l < count; ++l) {
    lv.size[l] = (int)sizes[l];
    lv.off[l] = off;
    off += sizes[l];
  }
  lv.count = count;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  int* im = static_cast<int*>(imap);
  int* c = static_cast<int*>(counts);
  const float* nz = static_cast<const float*>(noise);
  int* sl = static_cast<int*>(slots);
  int* h = static_cast<int*>(th);
  int* l = static_cast<int*>(tl);
  int* tc = static_cast<int*>(t);
  unsigned char* fl = static_cast<unsigned char*>(flags);
  int* ho = static_cast<int*>(hits);
  float* st = static_cast<float*>(stats);
  switch (kind) {
    case kLFU:
      return launch<kLFU>(window, id, n_items, lv, im, c, nz, sl, h, l, tc, fl, ho, st, s);
    case kFTPL:
      return launch<kFTPL>(window, id, n_items, lv, im, c, nz, sl, h, l, tc, fl, ho, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
