// The tree LFU, FTPL and GDS: one chunk of requests, in order, in one launch.
//
// The reference has no Pallas kernel here: it scans each automaton's
// per-request step over the chunk with lax.scan
// (src/repro/cachesim/tree_engines.py: make_lfu_tree_chunk,
// make_ftpl_tree_chunk, make_gds_tree_chunk), its victim search a
// lexicographic (hi, lo) min-tree over the slots at radix 64
// (src/repro/kernels/prefix_tree/ops.py, minpair_*).  The port's plain
// versions are ../ref.py's minpair_automaton_ref and gds_automaton_ref.
// This kernel computes the same, bit for bit: the hits, and the carry (imap,
// its scratch entry imap[N], counts, slots, both trees, LFU's clock; GDS's
// slot priorities and inflation value).
//
// A slot's key is (frequency, tick) for LFU, empty slots (-1, -1); for FTPL
// (sortable score, item id), the score float32(count) + noise, one float32
// add (__fadd_rn: no contraction); for GDS (sortable H, item id), empty slots
// (-1, -1), H = L + cost/size (one float32 add, __fadd_rn) with L the
// inflation value, raised to a real victim's H before the newcomer is keyed;
// inactive slots (INT32_MAX, INT32_MAX).  A tree node holds the least pair
// of its 64 children; the root is the least pair of the top level; the
// victim is the first leaf that holds the root's pair (the reference's group
// argmins prefer the first index at every level).
//
// Where the tree lives.  At C = 50 000 the leaves (two int32 arrays of
// 200 KB) do not fit one block's shared memory beside anything else; the
// ~800 nodes above them do.  So the levels above the leaves sit in shared
// memory for the whole chunk (written back at its end), and the leaves,
// slots, imap and counts stay in global memory, where they stay in L2.
//
// Least-leaf pointers.  Beside each upper node's pair the kernel keeps the
// index of its least leaf (the first leaf holding the node's pair), its own
// scratch, built at the chunk's start by all 256 threads from the carry's
// trees (16-byte leaf loads, atomicMin) and dropped at its end.  Up to
// 19 000 upper nodes (K up to ~1.2 million slots) they sit in shared memory
// beside the pairs (12 bytes a node); past that in global memory (the
// "pointers in L2" plan, to MAX_UPPER_NODES).  The root's pair and pointer
// stay in registers, so:
//  * a miss knows its victim without a descent; LFU's and FTPL's refused
//    admissions touch no memory;
//  * a hit never lowers its leaf's pair (LFU's count rises; FTPL's
//    float32(count) + noise does not fall and lo is the id; GDS's L does not
//    fall), so where the leaf is not its level-1 node's pointer nothing
//    above it can change: the hit writes its leaf and goes on;
//  * else (a hit on its group's least leaf, every admitted miss) the leaf
//    group is reduced with the new key substituted and the path climbs,
//    each level one warp-wide reduction of 64 children (two a lane;
//    redux.sync min over hi, over lo among the least hi, over the pointer
//    among the least pairs), stopping where a node keeps pair and pointer;
//  * GDS's L at an eviction is the victim's H decoded from the root's hi
//    (sortable is invertible on everything but -0.0 and NaN, whose H is
//    read from hval instead), so no load waits on the victim's H.
// The leaf group that holds the root's pointer stays in the warp's
// registers (two children a lane), loaded as soon as an update settles a
// new root, so that the hits between two misses hide its latency; a hit
// into that group updates the copy; and the victim's slot is read then too.
//
// The requests are walked by one warp, in tiles of 32: each lane loads one
// request's id (the next tile's ids in flight meanwhile), imap entry and
// count (and FTPL's noise); __match_any_sync gives its rank among the
// tile's equal ids, so the count after the request is the count before the
// tile plus rank + 1, and the last occurrence of an id writes its count
// back after the tile.  A request that changes no node (a hit off its
// level-1 node's least leaf; LFU's and FTPL's refused admission) depends on
// nothing an earlier request of its kind wrote, so the tile goes in
// segments: the requests before the first event (an admitted miss, a hit on
// its group's least leaf, any GDS miss) are applied by their lanes at once
// (each hit item's last request of the segment writes its leaf; the
// scratch entry is the segment's last request's), then the event runs
// alone, as above, and the rest of the tile is classified again.  A lane
// keeps its request's imap entry current through the tile: each write to
// imap is broadcast, and the lanes whose id it names take it.
//
// A sweep's grid of combos (repro_torch.sweep): one launch of a block a
// combo over the same ids, each block on its own rows of the stacked carry
// (Rows: the strides between the combos' rows) and its own pointer scratch
// in the L2 plan.  A block runs the single launch's code on its rows, so a
// row is bit for bit its combo's single launch; the blocks are independent
// chains on separate SMs.
//
// Bound on an H100: bytes (the ids, the touched imap, counts and noise
// entries, each written entry and the tree nodes on the touched paths)
// take a few microseconds at a 1e6-request chunk; the kernel is
// latency-bound, a chain of dependent events, each an update of ~3
// dependent warp-wide reductions a level, between segments of requests
// applied at once.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLFU = 0, kFTPL = 1, kGDS = 2;
constexpr int kShift = 6;  // radix 64
constexpr int kRadix = 1 << kShift;
constexpr int kThreads = 256;  // the prologue and epilogue; one warp runs the automaton
constexpr int kMaxLevels = 8;
constexpr unsigned kFull = 0xffffffffu;
// upper nodes whose pointers fit in shared memory beside their pairs (12
// bytes a node within the 227 KB a block can use)
constexpr int kSharedPointerNodes = 19000;

// The tree's levels, every loop over them unrolled so that no index is
// dynamic (the kernel keeps them in registers and parameters, not on a
// stack): size[l], and for l >= 1 at[l], the level's first node in the
// upper arrays; upper nodes in all, and the top level's at and size.
struct Levels {
  int at[kMaxLevels];
  int size[kMaxLevels];
  int count;
  int upper;
  int top_at;
  int top_size;
};

// A node's least pair and its least leaf.
struct Pair {
  int h, l, i;
};

// A group of 64 children, two a lane (children base + lane and base + lane
// + 32): their pairs and least leaves (a leaf's own index).  Children past
// the level's end read as (INT32_MAX, INT32_MAX) at leaf INT32_MAX.
struct Group {
  int base;
  int h0, l0, i0;
  int h1, l1, i1;
};

// The levels above the leaves: pairs in shared memory, pointers in shared
// memory (kShared) or in global memory; node x of level l >= 1 at
// (off[l] - off[1]) + x.
template <bool kShared>
struct Upper {
  int* hi;
  int* lo;
  int* ptr;
  __device__ __forceinline__ int get_ptr(int x) const {
    return kShared ? ptr[x] : __ldcg(ptr + x);
  }
  __device__ __forceinline__ void set_ptr(int x, int v) const {
    if (kShared) {
      ptr[x] = v;
    } else {
      __stcg(ptr + x, v);
    }
  }
};

__device__ __forceinline__ int sortable(float x) {
  const int b = __float_as_int(__fadd_rn(x, 0.0f));
  return b < 0 ? b ^ 0x7fffffff : b;
}

// The float whose sortable() is b: x + 0.0 for the x that gave it.
__device__ __forceinline__ float unsortable(int b) {
  return __int_as_float(b < 0 ? b ^ 0x7fffffff : b);
}

__device__ __forceinline__ Group load_leaves(const int* th, const int* tl, int base, int size,
                                             int lane) {
  Group g;
  g.base = base;
  const int c0 = base + lane, c1 = c0 + 32;
  const bool v0 = c0 < size, v1 = c1 < size;
  g.h0 = v0 ? __ldcg(th + c0) : INT_MAX;
  g.l0 = v0 ? __ldcg(tl + c0) : INT_MAX;
  g.h1 = v1 ? __ldcg(th + c1) : INT_MAX;
  g.l1 = v1 ? __ldcg(tl + c1) : INT_MAX;
  g.i0 = v0 ? c0 : INT_MAX;
  g.i1 = v1 ? c1 : INT_MAX;
  return g;
}

template <bool kShared>
__device__ __forceinline__ Group load_upper(const Upper<kShared>& u, int at, int base, int size,
                                            int lane) {
  Group g;
  g.base = base;
  const int c0 = base + lane, c1 = c0 + 32;
  const bool v0 = c0 < size, v1 = c1 < size;
  g.h0 = v0 ? u.hi[at + c0] : INT_MAX;
  g.l0 = v0 ? u.lo[at + c0] : INT_MAX;
  g.i0 = v0 ? u.get_ptr(at + c0) : INT_MAX;
  g.h1 = v1 ? u.hi[at + c1] : INT_MAX;
  g.l1 = v1 ? u.lo[at + c1] : INT_MAX;
  g.i1 = v1 ? u.get_ptr(at + c1) : INT_MAX;
  return g;
}

// The group's least (hi, lo) and the least leaf among the children that
// hold it, in every lane.
__device__ __forceinline__ Pair group_min(const Group& g) {
  // on equal pairs the first child's leaf is the lower (i0 < i1)
  const bool second = g.h1 < g.h0 || (g.h1 == g.h0 && g.l1 < g.l0);
  const int h = second ? g.h1 : g.h0;
  const int l = second ? g.l1 : g.l0;
  const int i = second ? g.i1 : g.i0;
  const int bh = __reduce_min_sync(kFull, h);
  const int bl = __reduce_min_sync(kFull, h == bh ? l : INT_MAX);
  const int bi = __reduce_min_sync(kFull, h == bh && l == bl ? i : INT_MAX);
  return {bh, bl, bi};
}

// Sets leaf `idx` of a leaf group to (h, l) where a lane holds it.
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

// Leaf idx has just taken a new key, and g is its leaf group with the key
// substituted: recompute its ancestors, stopping where a node keeps its
// pair and pointer.  Returns whether the root was recomputed (into root).
template <bool kShared>
__device__ __forceinline__ bool climb(const Upper<kShared>& u, const Levels& lv, Group g, int idx,
                                      Pair& root, int lane) {
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (l >= lv.count) break;
    const Pair p = group_min(g);
    const int node = idx >> (kShift * l);
    const int at = lv.at[l];
    const int x = at + node;
    if (u.hi[x] == p.h && u.lo[x] == p.l && u.get_ptr(x) == p.i) return false;
    __syncwarp();
    if (lane == 0) {
      u.hi[x] = p.h;
      u.lo[x] = p.l;
      u.set_ptr(x, p.i);
    }
    __syncwarp();
    g = load_upper(u, at, (node >> kShift) << kShift, lv.size[l], lane);
  }
  root = group_min(g);
  return true;
}

template <int KIND, bool kShared>
__device__ void run_warp(int* __restrict__ imap, int* __restrict__ counts,
                         const float* __restrict__ noise, int* __restrict__ slots,
                         int* __restrict__ th, int* __restrict__ tl, const Upper<kShared>& u,
                         int* __restrict__ tclock, float* __restrict__ hval,
                         float* __restrict__ lval, const int* __restrict__ ids, int window,
                         int n_items, const Levels& lv, unsigned char* __restrict__ flags,
                         int* __restrict__ hits_out) {
  const int lane = threadIdx.x;
  const int top = lv.count - 1;
  const int k_slots = lv.size[0];
  const int t0 = KIND == kLFU ? *tclock : 0;
  float L = KIND == kGDS ? *lval : 0.0f;  // GDS: the inflation value, warp-uniform
  int hits = 0, scratch = -1;

  // the root, the leaf group that holds its pointer, and the victim's item
  Group cg;
  Pair root;
  if (top == 0) {
    cg = load_leaves(th, tl, 0, k_slots, lane);
    root = group_min(cg);
  } else {
    root = group_min(load_upper(u, lv.top_at, 0, lv.top_size, lane));
    cg = load_leaves(th, tl, root.i & ~(kRadix - 1), k_slots, lane);
  }
  int vslot = __ldcg(slots + root.i);

  int jn = lane < window ? __ldg(ids + lane) : -1;
  for (int base = 0; base < window; base += 32) {
    const int n = min(32, window - base);
    const int j = lane < n ? jn : -1;
    if (base + 32 + lane < window) jn = __ldg(ids + base + 32 + lane);  // the next tile's
    int mine = -1, f = 0, key = 0;
    float prio = 0.0f;  // GDS: the request's cost / size (`noise` holds them)
    float nz = 0.0f;    // FTPL: the request's noise
    if (lane < n) {
      mine = __ldcg(imap + j);
      if (KIND == kGDS) {
        prio = __ldg(noise + j);
      } else {
        f = __ldcg(counts + j);
        if (KIND == kFTPL) nz = __ldg(noise + j);
      }
    }
    // the lanes of the tile that request j: the count's rank, and whether
    // this lane is j's last in the tile
    const unsigned peers = __match_any_sync(kFull, j);
    const unsigned below = (1u << lane) - 1u;
    const bool final = (peers & ~below & ~(below + 1u)) == 0u;
    f += __popc(peers & below) + 1;
    if (KIND == kFTPL && lane < n) key = sortable(__fadd_rn(__int2float_rn(f), nz));
    // this lane's key were it written now (GDS's hi from the current L)
    const int my_h = KIND == kLFU ? f : key;
    const int my_l = KIND == kLFU ? t0 + base + lane : j;

    // Lanes pos.. : the tile's requests not yet applied.  Those before the
    // first event (a request that changes a node, or evicts) change only
    // their own leaf and are applied by all lanes at once; the event then
    // runs alone; then the rest are classified again.
    for (int pos = 0; pos < n;) {
      bool simple = false;
      if (lane >= pos && lane < n) {
        if (mine >= 0) {  // a hit off its level-1 node's least leaf
          simple = top == 0 ? mine != root.i : u.get_ptr(mine >> kShift) != mine;
        } else if (KIND != kGDS) {  // a refused admission
          simple = KIND == kLFU ? my_h < root.h : my_h <= root.h;
        }
      }
      const unsigned pending = n == 32 ? kFull : (1u << n) - 1u;
      const unsigned events = __ballot_sync(kFull, !simple) & pending & ~((1u << pos) - 1u);
      const int e = events != 0u ? __ffs(events) - 1 : n;
      if (e > pos) {
        const unsigned seg = (e == 32 ? kFull : (1u << e) - 1u) & ~((1u << pos) - 1u);
        const bool in_seg = ((seg >> lane) & 1u) != 0u;
        const bool hit = mine >= 0;
        const unsigned seg_hits = __ballot_sync(kFull, in_seg && hit);
        hits += __popc(seg_hits);
        if (flags != nullptr && in_seg) flags[base + lane] = hit;
        // each hit item's last request of the segment writes its leaf
        const bool writer = in_seg && hit && (peers & seg & ~below & ~(below + 1u)) == 0u;
        int wh = my_h;
        if (KIND == kGDS && writer) {
          const float h = __fadd_rn(L, prio);
          wh = sortable(h);
          hval[mine] = h;
        }
        if (writer) {
          th[mine] = wh;
          tl[mine] = my_l;
        }
        unsigned into = __ballot_sync(kFull, writer && (mine & ~(kRadix - 1)) == cg.base);
        while (into != 0u) {  // hits into the root's leaf group: its copy too
          const int b = __ffs(into) - 1;
          into &= into - 1u;
          substitute(cg, __shfl_sync(kFull, mine, b), __shfl_sync(kFull, wh, b),
                     __shfl_sync(kFull, my_l, b));
        }
        if (KIND != kGDS) {  // the scratch entry: the segment's last request's
          const int sv = hit ? (KIND == kFTPL ? mine : -1) : root.i;
          scratch = __shfl_sync(kFull, sv, e - 1);
        }
        __syncwarp();
      }
      if (e == n) break;
      pos = e + 1;
      const int q = e;
      const int jq = __shfl_sync(kFull, j, q);
      const int slot = __shfl_sync(kFull, mine, q);
      int nh = __shfl_sync(kFull, my_h, q);
      const int nl = __shfl_sync(kFull, my_l, q);
      const bool hit = slot >= 0;
      hits += hit;
      if (flags != nullptr && lane == 0) flags[base + q] = hit;

      int idx = hit ? slot : root.i;
      bool write = true;
      if (hit) {
        scratch = KIND == kFTPL ? idx : -1;
      } else {
        write = KIND == kGDS || (KIND == kLFU ? nh >= root.h : nh > root.h);
        if (!write) {
          scratch = idx;
        } else {
          const int old = vslot;
          if (KIND == kGDS && old >= 0) {
            // evict first: L takes the victim's H, decoded from the root's
            // hi (a zero or NaN H is read, as it may have had another sign
            // or payload)
            L = unsortable(root.h);
            if (L == 0.0f || L != L) L = __ldcg(hval + idx);
          }
          if (lane == 0) {
            if (old >= 0) imap[old] = -1;
            imap[jq] = idx;
            slots[idx] = jq;
          }
          if (old >= 0 && j == old) mine = -1;
          if (j == jq) mine = idx;
          if (KIND != kGDS && old < 0) scratch = -1;
        }
      }
      if (write) {
        if (KIND == kGDS) {  // a hit or a miss: H = L + cost/size of the request
          const float h = __fadd_rn(L, __shfl_sync(kFull, prio, q));
          nh = sortable(h);
          if (lane == 0) hval[idx] = h;
        }
        if (lane == 0) {
          th[idx] = nh;
          tl[idx] = nl;
        }
        const int gb = idx & ~(kRadix - 1);
        // a miss's victim is always in the cached group; a hit may be
        if (gb == cg.base) substitute(cg, idx, nh, nl);
        // the rule: a hit off its level-1 node's least leaf changes nothing
        // above the leaf (level 1's node idx >> 6 is upper node idx >> 6)
        const bool least = !hit || (top == 0 ? idx == root.i : u.get_ptr(idx >> kShift) == idx);
        if (least) {
          Group g;
          if (gb == cg.base) {
            g = cg;
          } else {
            g = load_leaves(th, tl, gb, k_slots, lane);
            substitute(g, idx, nh, nl);
          }
          const int was = root.i;
          if (climb(u, lv, g, idx, root, lane)) {
            const int rb = root.i & ~(kRadix - 1);
            if (rb == gb) {
              cg = g;
            } else if (rb != cg.base) {
              cg = load_leaves(th, tl, rb, k_slots, lane);  // in flight until the next miss
            }
          }
          // the victim's item: the newcomer where the root stays on this
          // leaf, else read (in flight until the next miss)
          if (root.i == idx) {
            vslot = jq;
          } else if (root.i != was) {
            vslot = __ldcg(slots + root.i);
          }
        }
      }
      __syncwarp();
    }
    if (KIND != kGDS && lane < n && final) counts[j] = f;
    __syncwarp();
  }
  if (lane == 0) {
    // GDS writes -1 into the scratch entry at every request that evicts
    // nothing, and first of all at the chunk's start (the reference's
    // pending write): so -1 after every chunk
    imap[n_items] = KIND == kGDS ? -1 : scratch;
    if (KIND == kLFU) *tclock = t0 + window;
    if (KIND == kGDS) *lval = L;
    *hits_out = hits;
  }
}

// Every upper node's least leaf, from the carry's trees: level 1 from the
// leaves (16-byte loads, a leaf that holds its node's pair bids its index
// by atomicMin), each level above from the one below.
template <bool kShared>
__device__ void build_pointers(const int* __restrict__ th, const int* __restrict__ tl,
                               const Upper<kShared>& u, const Levels& lv, int upper) {
  const int tid = threadIdx.x;
  for (int x = tid; x < upper; x += kThreads) u.set_ptr(x, INT_MAX);
  __syncthreads();
  const int k = lv.size[0];
  const bool aligned = ((reinterpret_cast<uintptr_t>(th) | reinterpret_cast<uintptr_t>(tl)) &
                        15) == 0;
  const int quads = aligned ? k / 4 : 0;
  auto bid = [&](int leaf, int h, int l) {
    const int x = leaf >> kShift;  // level 1 starts the upper arrays
    if (h == u.hi[x] && l == u.lo[x]) atomicMin(u.ptr + x, leaf);
  };
  constexpr int kUnroll = 4;
  for (int q = tid; q < quads; q += kUnroll * kThreads) {
    int4 h[kUnroll], l[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int qq = q + r * kThreads;
      if (qq < quads) {
        h[r] = __ldcg(reinterpret_cast<const int4*>(th) + qq);
        l[r] = __ldcg(reinterpret_cast<const int4*>(tl) + qq);
      }
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int qq = q + r * kThreads;
      if (qq < quads) {
        bid(4 * qq, h[r].x, l[r].x);
        bid(4 * qq + 1, h[r].y, l[r].y);
        bid(4 * qq + 2, h[r].z, l[r].z);
        bid(4 * qq + 3, h[r].w, l[r].w);
      }
    }
  }
  for (int leaf = 4 * quads + tid; leaf < k; leaf += kThreads) {
    bid(leaf, __ldcg(th + leaf), __ldcg(tl + leaf));
  }
  __syncthreads();
#pragma unroll
  for (int l = 2; l < kMaxLevels; ++l) {
    if (l >= lv.count) break;
    const int below = lv.at[l - 1];
    const int at = lv.at[l];
    for (int c = tid; c < lv.size[l - 1]; c += kThreads) {
      const int x = at + (c >> kShift);
      if (u.hi[below + c] == u.hi[x] && u.lo[below + c] == u.lo[x]) {
        atomicMin(u.ptr + x, u.get_ptr(below + c));
      }
    }
    __syncthreads();
  }
}

// A grid of combos: block b runs row b of each stacked carry tensor, whose
// rows lie `stride` elements apart, and row b of the ids: `ids` apart, 0
// where the combos share one chunk (a sweep), the window where each has its
// own (a fleet's tenants).
struct Rows {
  long long imap, items, slots, tree, pointers, flags, ids;
};

template <class T>
__device__ __forceinline__ T* row_of(T* p, long long stride) {
  return p == nullptr ? p : p + (long long)blockIdx.x * stride;
}

template <int KIND, bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
    minpair_kernel(int* __restrict__ imap, int* __restrict__ counts,
                   const float* __restrict__ noise, int* __restrict__ slots, int* __restrict__ th,
                   int* __restrict__ tl, int* __restrict__ tclock, float* __restrict__ hval,
                   float* __restrict__ lval, const int* __restrict__ ids, int window, int n_items,
                   Levels lv, int* __restrict__ gptr, unsigned char* __restrict__ flags,
                   int* __restrict__ hits_out, float* __restrict__ stats, Rows rs) {
  extern __shared__ int smem[];
  // this block's combo: its rows of the carry, its pointer scratch, flags
  // and outputs
  imap = row_of(imap, rs.imap);
  counts = row_of(counts, rs.items);
  noise = row_of(noise, rs.items);
  slots = row_of(slots, rs.slots);
  hval = row_of(hval, rs.slots);
  th = row_of(th, rs.tree);
  tl = row_of(tl, rs.tree);
  gptr = row_of(gptr, rs.pointers);
  flags = row_of(flags, rs.flags);
  ids = row_of(ids, rs.ids);
  tclock = row_of(tclock, 1);
  lval = row_of(lval, 1);
  hits_out = row_of(hits_out, 1);
  stats = row_of(stats, 3);
  __shared__ int s_occ;
  const int up = lv.size[0];  // the upper levels follow the leaves
  const int upper = lv.upper;
  Upper<kShared> u{smem, smem + upper, kShared ? smem + 2 * upper : gptr};
  for (int x = threadIdx.x; x < upper; x += blockDim.x) {
    u.hi[x] = th[up + x];
    u.lo[x] = tl[up + x];
  }
  if (threadIdx.x == 0) s_occ = 0;
  __syncthreads();
  if (upper > 0) build_pointers(th, tl, u, lv, upper);
  if (threadIdx.x < 32) {
    run_warp<KIND, kShared>(imap, counts, noise, slots, th, tl, u, tclock, hval, lval, ids,
                            window, n_items, lv, flags, hits_out);
  }
  __syncthreads();
  for (int x = threadIdx.x; x < upper; x += blockDim.x) {
    th[up + x] = u.hi[x];
    tl[up + x] = u.lo[x];
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

template <int KIND, bool kShared>
int launch(int rows, const Rows& rs, int window, const int* ids, int n_items, const Levels& lv,
           int* gptr, int* imap, int* counts, const float* noise, int* slots, int* th, int* tl,
           int* t, float* hval, float* lval, unsigned char* flags, int* hits, float* stats,
           cudaStream_t stream) {
  const size_t smem = (size_t)((kShared ? 3 : 2) * lv.upper) * sizeof(int);
  if (smem + 1024 > 48 * 1024) {  // with the static shared memory, past 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        minpair_kernel<KIND, kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  minpair_kernel<KIND, kShared><<<rows, kThreads, smem, stream>>>(
      imap, counts, noise, slots, th, tl, t, hval, lval, ids, window, n_items, lv, gptr, flags,
      hits, stats, rs);
  return (int)cudaGetLastError();
}

template <bool kShared>
int launch_kind(int kind, int rows, const Rows& rs, int window, const int* ids, int n_items,
                const Levels& lv, int* gptr, int* imap, int* counts, const float* noise,
                int* slots, int* th, int* tl, int* t, float* hval, float* lval,
                unsigned char* flags, int* hits, float* stats, cudaStream_t s) {
  switch (kind) {
    case kLFU:
      return launch<kLFU, kShared>(rows, rs, window, ids, n_items, lv, gptr, imap, counts, noise,
                                   slots, th, tl, t, hval, lval, flags, hits, stats, s);
    case kFTPL:
      return launch<kFTPL, kShared>(rows, rs, window, ids, n_items, lv, gptr, imap, counts, noise,
                                    slots, th, tl, t, hval, lval, flags, hits, stats, s);
    case kGDS:
      return launch<kGDS, kShared>(rows, rs, window, ids, n_items, lv, gptr, imap, counts, noise,
                                   slots, th, tl, t, hval, lval, flags, hits, stats, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 0 lfu (t its int32 clock, noise null), 1 ftpl (noise (N,) float32,
// t null), 2 gds (noise the (N,) float32 cost / size, counts and t null, hval
// the (K,) float32 slot priorities, lval the () float32 inflation value).
// sizes: the min-tree's `count` level sizes, leaves first (the slot count).
// pointers: null for the shared-memory plan (at most 19 000 nodes above
// the leaves), else an int32 scratch of one entry a node above the leaves
// (the L2 plan).  imap holds N + 1 entries, counts N.  flags: null, or one
// byte a request.  hits: one int32; stats: three float32 (reward, aux,
// occupancy).
// rows: the combos of a grid, a block each; each tensor above then holds
// `rows` rows, one a combo: imap rows N + 1 apart, counts and noise N,
// slots and hval K, each tree its storage, the pointer scratch one row of
// upper nodes, flags the window, t, lval and hits one, stats three; the ids
// rows `ids_stride` apart (0: one chunk for every combo, a sweep's).
// rows = 1 is the single launch.
extern "C" int repro_minpair_automaton(int kind, int rows, int window, const void* ids,
                                       long long ids_stride, int n_items, int count, const long long* sizes,
                                       void* pointers, void* imap, void* counts,
                                       const void* noise, void* slots, void* th, void* tl,
                                       void* t, void* hval, void* lval, void* flags, void* hits,
                                       void* stats, void* stream) {
  if (rows < 1 || count < 1 || count > kMaxLevels || window < 1 || n_items < 1 ||
      sizes[0] < 1 || sizes[count - 1] > kRadix || (ids_stride != 0 && ids_stride < window)) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv{};
  long long upper = 0;
  for (int l = 0; l < count; ++l) {
    lv.size[l] = (int)sizes[l];
    if (l >= 1) {
      lv.at[l] = (int)upper;
      upper += sizes[l];
    }
  }
  lv.count = count;
  if (upper > INT_MAX / 3 || (pointers == nullptr && upper > kSharedPointerNodes)) {
    return (int)cudaErrorInvalidValue;
  }
  lv.upper = (int)upper;
  lv.top_at = lv.at[count - 1];
  lv.top_size = lv.size[count - 1];
  const Rows rs{(long long)n_items + 1, n_items, sizes[0], sizes[0] + upper, upper, window,
                ids_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  int* gp = static_cast<int*>(pointers);
  int* im = static_cast<int*>(imap);
  int* c = static_cast<int*>(counts);
  const float* nz = static_cast<const float*>(noise);
  int* sl = static_cast<int*>(slots);
  int* h = static_cast<int*>(th);
  int* l = static_cast<int*>(tl);
  int* tc = static_cast<int*>(t);
  float* hv = static_cast<float*>(hval);
  float* lv_ = static_cast<float*>(lval);
  unsigned char* fl = static_cast<unsigned char*>(flags);
  int* ho = static_cast<int*>(hits);
  float* st = static_cast<float*>(stats);
  if (gp == nullptr) {
    return launch_kind<true>(kind, rows, rs, window, id, n_items, lv, gp, im, c, nz, sl, h, l, tc,
                             hv, lv_, fl, ho, st, s);
  }
  return launch_kind<false>(kind, rows, rs, window, id, n_items, lv, gp, im, c, nz, sl, h, l, tc,
                            hv, lv_, fl, ho, st, s);
}
