// The tree LRU: one chunk of requests, by reuse distance, in one launch.
//
// The reference has no Pallas kernel here: it scans sub-chunks of the chunk
// with lax.scan (src/repro/cachesim/tree_engines.py, make_lru_tree_chunk).
// The port's plain version is ../ref.py's tree_lru_ref.  This kernel computes
// the same, bit for bit: the hits, and the carry (the ring's count tree,
// last, pos, nseen).
//
// A request hits iff at most cap - 1 distinct items were requested since its
// previous request (its reuse distance), which is LRU.  Each request takes
// the next ring position; last[j] is the position of item j's last request,
// and the radix-16 int32 tree counts the marks (one at each last).  The
// reference's sub-chunk width and delayed writes do not show in the carry
// after a chunk, so the blocking here is the kernel's own:
//
// * repro_tree_lru_chunk: one block of 256 threads, a thread a request of a
//   256-request sub-chunk, the sub-chunks in order (the next one's ids in
//   flight meanwhile).  A thread finds its request's previous one in the
//   sub-chunk, and whether it is its item's last there, from a shared hash
//   table of the sub-chunk's ids, each slot an id and a 256-bit mask of
//   the positions that request it (a warp's equal ids inserted once, by
//   __match_any_sync); else it reads last[j].  Its reuse distance is the
//   tree's marks after that position (the tree's total less a prefix count:
//   a node's left siblings, level by level) plus the dominance term: the
//   requests of the sub-chunk between the two whose own previous request
//   lies at or before it (each a distinct item not yet counted), counted in
//   shared memory four at a time.  After a barrier each item's mark moves
//   once: the first request of an item removes its old mark, the last
//   inserts one at its position, by integer atomicAdd along the leaf's
//   path, exact in any order; the tree's total is kept in a register.
//   Where the tree lives: the levels from the lowest one that fits (level 1
//   where all above the leaves fit in 204 KB, as at a ring of 2^18; level 2
//   at 2^21) sit in shared memory for the whole chunk, each padded to 16
//   ints, and are written back at its end; their path adds are shared
//   atomics.  The levels below stay in global memory (L2), read a sibling
//   group at a time in 16-byte loads (four for 16 children, those past the
//   node not issued).  A prefix count so issues at most 4 loads a level to
//   L2, on at most 2 levels: one SM's requests to L2 serialise, and scalar
//   loads of 16 children on every level would be ~96 a thread.  The table
//   costs each thread a probe and 8 words, where a scan of the sub-chunk's
//   256 ids would cost 256 compares.
// * repro_tree_lru_compact: the ring compaction a chunk may need, when
//   pos + window > m, decided on the device: a grid over the catalog and the
//   ring.  Where it is due, each marked item's new position is its rank
//   among the newest min(marks, cap) marks (its prefix count in the tree,
//   less the dropped marks; -1 if dropped), the leaves become the kept
//   prefix, and the decision and the new pos (the kept count rounded up to
//   16) go to a scratch that the chunk's launch reads; where it is not due,
//   the leaves are the tree's own.  The wrapper then rebuilds the tree from
//   the leaves with the int32 tree build (prefix_tree/csrc/segsum.cu).
//
// A sweep's grid of combos: one chunk launch of a block a combo over the
// same ids (a fleet's: over a row of ids a tenant), each block on its own
// rows of the stacked carry (Rows), the tree rows a multiple of 4 ints
// apart so that the 16-byte loads hold.  Where any combo's host bound says
// a compaction may be due, one compaction launch covers every combo (the
// grid's y axis the combo; each decides from its own pos, and one not due
// copies its own leaves) and one int32 build rebuilds every combo's tree;
// the chunk's launch resets each decision it reads.  A row is bit for bit
// its combo's single launch.
//
// Bound on an H100: bytes, the ids read and each distinct item's last read
// and written, and the tree nodes on the marks' paths, take a few
// microseconds at a 1e6-request chunk; the chunk kernel is latency-bound, a
// chain of dependent sub-chunks, each a hash table of 256 ids, a prefix
// read of the leaf group (and at 2^21 a level-1 group) through L2 and
// shared memory above, the dominance loop and a path of atomics.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kShift = 4;  // radix 16
constexpr int kRadix = 1 << kShift;
constexpr int kThreads = 256;  // a sub-chunk: one thread a request
constexpr int kMaxLevels = 8;  // a ring below 2^30 positions
constexpr int kCompactThreads = 256;
// the sub-chunk's hash table of ids: 512 slots for at most 256 ids
constexpr int kTableShift = 9;
constexpr int kTable = 1 << kTableShift;
constexpr unsigned kFull = 0xffffffffu;
// the ints of tree levels the chunk keeps in shared memory (204 KB, beside
// its ~20 KB of static shared memory within the 227 KB a block can use)
constexpr int kSharedInts = 51 * 1024;

// The ring's tree: level l at off[l] in global memory; levels s0 and above
// also at soff[l] in shared memory (each padded to 16 ints), sints ints in
// all; bit l of vec set where global level l takes 16-byte loads (aligned,
// and whole quads: no load past the tree's end).
struct Ring {
  long long off[kMaxLevels];
  int size[kMaxLevels];
  int soff[kMaxLevels];
  int count;
  int s0;
  int sints;
  unsigned vec;
};

// Children grp .. last (last - grp + 1 <= 16 of them) of one level summed,
// in 16-byte loads (scalars where the level is not 16-byte aligned), those
// past last not issued.  Global reads go through L2 (__ldcg), where the
// block's atomics land.
template <bool kGlobal>
__device__ __forceinline__ int group_sum(const int* lev, int grp, int last, bool vec) {
  const int n = last - grp + 1;
  int acc = 0;
#pragma unroll
  for (int qd = 0; qd < kRadix / 4; ++qd) {
    const int rest = n - 4 * qd;
    if (rest > 0) {
      const int* at = lev + grp + 4 * qd;
      int4 v;
      if (!kGlobal || vec) {
        v = kGlobal ? __ldcg(reinterpret_cast<const int4*>(at))
                    : *reinterpret_cast<const int4*>(at);
      } else {  // global levels only: shared levels are padded and aligned
        v.x = __ldcg(at);
        v.y = rest > 1 ? __ldcg(at + 1) : 0;
        v.z = rest > 2 ? __ldcg(at + 2) : 0;
        v.w = rest > 3 ? __ldcg(at + 3) : 0;
      }
      acc += v.x + (rest > 1 ? v.y : 0) + (rest > 2 ? v.z : 0) + (rest > 3 ? v.w : 0);
    }
  }
  return acc;
}

// Marks at positions [0, p], p >= 0: at the leaves the group's children up
// to p, above each node's left siblings.  The reads of every level are
// independent (predicated and unrolled, all in flight at once).
__device__ __forceinline__ int prefix_count(const int* __restrict__ tree, const int* s_tree,
                                            const Ring& r, int p) {
  int acc = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < r.count) {
      const int node = p >> (kShift * l);
      const int grp = node & ~(kRadix - 1);
      const int last = l == 0 ? node : node - 1;
      if (last >= grp) {
        acc += l < r.s0 ? group_sum<true>(tree + r.off[l], grp, last, (r.vec >> l) & 1u)
                        : group_sum<false>(s_tree + r.soff[l], grp, last, true);
      }
    }
  }
  return acc;
}

// Adds delta to the leaf at position q and to each of its ancestors.
__device__ __forceinline__ void add_path(int* __restrict__ tree, int* s_tree, const Ring& r,
                                         int q, int delta) {
  for (int l = 0; l < r.count; ++l) {
    if (l < r.s0) {
      atomicAdd(tree + r.off[l] + q, delta);
    } else {
      atomicAdd(s_tree + r.soff[l] + q, delta);
    }
    q >>= kShift;
  }
}

// The marks in the tree: the sum of its top level (at most 16 nodes).
__device__ __forceinline__ int total_marks(const int* __restrict__ tree, const int* s_tree,
                                           const Ring& r) {
  const int top = r.count - 1;
  int total = 0;
  for (int k = 0; k < r.size[top]; ++k) {
    total += top < r.s0 ? __ldcg(tree + r.off[top] + k) : s_tree[r.soff[top] + k];
  }
  return total;
}

__global__ void __launch_bounds__(kCompactThreads)
    compact_kernel(const int* __restrict__ tree, int* __restrict__ last,
                   const int* __restrict__ pos, const int* __restrict__ cap, int window, Ring r,
                   int n_items, int* __restrict__ scratch, long long tree_stride,
                   long long last_stride, long long scratch_stride) {
  // this block's combo (the grid's y axis; 0 for one combo)
  tree += blockIdx.y * tree_stride;
  last += blockIdx.y * last_stride;
  scratch += blockIdx.y * scratch_stride;
  pos += blockIdx.y;
  cap += blockIdx.y;
  const int m = r.size[0];
  const bool due = (long long)*pos + window > m;
  const int nmarks = total_marks(tree, nullptr, r);  // r.s0 == r.count: all in global memory
  const int kept = min(nmarks, *cap);
  const int dropped = nmarks - kept;
  const int span = max(n_items, m);
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < span; t += gridDim.x * blockDim.x) {
    if (due && t < n_items) {
      const int q = last[t];
      if (q >= 0) {
        const int rank = prefix_count(tree, nullptr, r, q) - 1 - dropped;
        last[t] = rank >= 0 ? rank : -1;
      }
    }
    if (t < m) scratch[t] = due ? (t < kept) : __ldg(tree + t);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scratch[m] = due;
    scratch[m + 1] = (kept + kRadix - 1) & ~(kRadix - 1);
  }
}

// The sub-chunk's ids in a shared hash table (kTable slots, open
// addressing): each distinct id's slot holds the id and a 256-bit mask of
// the positions that request it.  A warp's equal ids (__match_any_sync)
// are inserted once, by their first lane, with the warp's mask.
struct Table {
  int key[kTable];      // -1: empty
  unsigned bits[kTable][kThreads / 32];
};

// Inserts the thread's id j (>= 0; -1 inserts nothing) with its warp's
// peers; returns the id's slot in every thread that has one.
__device__ __forceinline__ int table_insert(Table& t, int j) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, j);
  const int leader = __ffs(peers) - 1;
  int slot = -1;
  if (lane == leader && j >= 0) {
    slot = (int)(((unsigned)j * 0x9E3779B1u) >> (32 - kTableShift));
    for (;;) {
      const int held = atomicCAS(&t.key[slot], -1, j);
      if (held == -1 || held == j) break;
      slot = (slot + 1) & (kTable - 1);
    }
    atomicOr(&t.bits[slot][threadIdx.x >> 5], peers);
  }
  return __shfl_sync(kFull, slot, leader);
}

// A grid of combos: block b runs row b of each stacked carry tensor: the
// tree rows `tree_stride` ints apart, last `last_stride`, the compaction
// states `state_stride`, the ids `ids_stride` (0: a sweep's one chunk for
// every combo; the window: a fleet's tenants, a row of ids each), flags a
// window; pos, nseen, cap and hits one int apart, stats three floats.
struct Rows {
  long long tree, last, state, ids;
};

template <class T>
__device__ __forceinline__ T* row_of(T* p, long long stride) {
  return p == nullptr ? p : p + (long long)blockIdx.x * stride;
}

__global__ void __launch_bounds__(kThreads)
    tree_lru_kernel(int* __restrict__ tree, int* __restrict__ last, int* __restrict__ pos,
                    int* __restrict__ nseen, const int* __restrict__ cap,
                    const int* __restrict__ ids, int window, Ring r,
                    int* __restrict__ state, unsigned char* __restrict__ flags,
                    int* __restrict__ hits_out, float* __restrict__ stats, Rows rs) {
  extern __shared__ int4 smem4[];
  tree = row_of(tree, rs.tree);
  last = row_of(last, rs.last);
  pos = row_of(pos, 1);
  nseen = row_of(nseen, 1);
  cap = row_of(cap, 1);
  state = row_of(state, rs.state);
  ids = row_of(ids, rs.ids);
  flags = row_of(flags, (long long)window);
  hits_out = row_of(hits_out, 1);
  stats = row_of(stats, 3);
  int* s_tree = reinterpret_cast<int*>(smem4);  // levels s0 and above
  __shared__ __align__(16) Table s_table;
  __shared__ __align__(16) int s_prev[kThreads];
  __shared__ int s_moved[2];  // marks inserted, marks removed, this sub-chunk
  __shared__ int s_count[2];  // hits, requests that found no mark
  const int tid = threadIdx.x;
  const int m = r.size[0];
  int p0 = *pos;
  if (state[0]) p0 = state[1];
  const int c = *cap;
  const int seen0 = *nseen;
  if ((long long)p0 + window > m) {  // the caller's bound was wrong: touch nothing
    if (tid == 0) {
      *hits_out = INT_MIN;
      stats[0] = stats[1] = stats[2] = __int_as_float(0x7fc00000);
    }
    return;
  }
  for (int l = r.s0; l < r.count; ++l) {
    for (int x = tid; x < r.size[l]; x += kThreads) {
      s_tree[r.soff[l] + x] = __ldcg(tree + r.off[l] + x);
    }
  }
  for (int x = tid; x < kTable; x += kThreads) {
    s_table.key[x] = -1;
    for (int w = 0; w < kThreads / 32; ++w) s_table.bits[x][w] = 0u;
  }
  if (tid < 2) s_count[tid] = 0;
  __syncthreads();
  // the compaction's decision is consumed: a later chunk whose compaction
  // was not launched reads 0 here
  if (tid == 0) state[0] = 0;
  int total = total_marks(tree, s_tree, r);
  int hits = 0, unseen = 0;
  int jn = tid < window ? __ldg(ids + tid) : -1;

  for (int base = 0; base < window; base += kThreads) {
    const int n = min(kThreads, window - base);
    const int at = p0 + base;  // the sub-chunk's first position
    const int j = tid < n ? jn : -1;
    if (base + kThreads + tid < window) jn = __ldg(ids + base + kThreads + tid);  // the next's
    const int lastg = j >= 0 ? __ldcg(last + j) : -1;
    const int slot = table_insert(s_table, j);
    __syncthreads();
    if (tid < 2) s_moved[tid] = 0;
    // the request's previous one in the sub-chunk (the highest position
    // below it that requests j), and whether it is j's last
    int prev_in = -1, prevp = -1;
    bool final = true;
    if (j >= 0) {
      const int w0 = tid >> 5;
      const unsigned below = (1u << (tid & 31)) - 1u;
      for (int w = kThreads / 32 - 1; w >= 0; --w) {
        unsigned b = s_table.bits[slot][w];
        if (w > w0) {
          final &= b == 0u;
        } else {
          if (w == w0) {
            final &= (b & ~below & ~(below + 1u)) == 0u;
            b &= below;
          }
          if (prev_in < 0 && b != 0u) prev_in = 32 * w + 31 - __clz(b);
        }
      }
      prevp = prev_in >= 0 ? at + prev_in : lastg;
      s_prev[tid] = prevp;
    }
    __syncthreads();
    if (j >= 0) {
      bool hit = false;
      if (prevp >= 0) {
        // marks after prevp before the sub-chunk, then the sub-chunk's
        // requests between the two whose previous request is at or before
        // it, read four at a time
        int d = prevp >= at ? 0 : total - prefix_count(tree, s_tree, r, prevp);
        const int k0 = max(prevp - at + 1, 0);
        for (int k = k0 & ~3; k < tid; k += 4) {
          const int4 v = *reinterpret_cast<const int4*>(s_prev + k);
          d += (k >= k0 && v.x <= prevp) + (k + 1 >= k0 && k + 1 < tid && v.y <= prevp) +
               (k + 2 >= k0 && k + 2 < tid && v.z <= prevp) +
               (k + 3 >= k0 && k + 3 < tid && v.w <= prevp);
        }
        hit = d <= c - 1;
      } else {
        ++unseen;
      }
      hits += hit;
      if (flags != nullptr) flags[base + tid] = hit;
    }
    __syncthreads();  // every read of the tree, of last and of the table is done
    const bool drop = lastg >= 0 && prev_in < 0;
    if (j >= 0) {
      if (drop) add_path(tree, s_tree, r, lastg, -1);
      if (final) {
        add_path(tree, s_tree, r, at + tid, 1);
        last[j] = at + tid;
      }
      if (prev_in < 0) {  // the sub-chunk's first request of j empties its slot
        s_table.key[slot] = -1;
        for (int w = 0; w < kThreads / 32; ++w) s_table.bits[slot][w] = 0u;
      }
    }
    const unsigned ins = __ballot_sync(kFull, j >= 0 && final);
    const unsigned del = __ballot_sync(kFull, j >= 0 && drop);
    if ((tid & 31) == 0) {
      atomicAdd(&s_moved[0], __popc(ins));
      atomicAdd(&s_moved[1], __popc(del));
    }
    __syncthreads();
    total += s_moved[0] - s_moved[1];
  }

  atomicAdd(&s_count[0], hits);
  atomicAdd(&s_count[1], unseen);
  __syncthreads();
  for (int l = r.s0; l < r.count; ++l) {
    for (int x = tid; x < r.size[l]; x += kThreads) tree[r.off[l] + x] = s_tree[r.soff[l] + x];
  }
  if (tid == 0) {
    const int seen = seen0 + s_count[1];
    *pos = p0 + window;
    *nseen = seen;
    *hits_out = s_count[0];
    stats[0] = (float)s_count[0];  // reward: the automata's reward is their hits
    stats[1] = 0.0f;               // aux: no threshold
    stats[2] = (float)min(seen, c);
  }
}

// The ring's levels; with `shared`, the lowest level from 1 up from which
// all fit in kSharedInts goes to shared memory with those above (none if
// none fits, or with one level).
bool ring_of(const long long* sizes, int count, const void* tree, bool shared, Ring& r) {
  if (count < 1 || count > kMaxLevels || sizes[0] < kRadix || sizes[0] >= (1LL << 30)) {
    return false;
  }
  long long off = 0;
  for (int l = 0; l < count; ++l) {
    r.size[l] = (int)sizes[l];
    r.off[l] = off;
    off += sizes[l];
  }
  r.count = count;
  r.s0 = count;
  r.sints = 0;
  for (int s = 1; shared && s < count; ++s) {
    int ints = 0;
    for (int l = s; l < count; ++l) ints += (r.size[l] + kRadix - 1) & ~(kRadix - 1);
    if (ints <= kSharedInts) {
      r.s0 = s;
      r.sints = ints;
      break;
    }
  }
  for (int l = r.s0, at = 0; l < count; ++l) {
    r.soff[l] = at;
    at += (r.size[l] + kRadix - 1) & ~(kRadix - 1);
  }
  r.vec = 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(tree) & 15) == 0;
  for (int l = 0; l < r.s0; ++l) {
    if (aligned && r.off[l] % 4 == 0 && r.size[l] % 4 == 0) r.vec |= 1u << l;
  }
  return true;
}

}  // namespace

// The compaction a chunk of `window` requests may need (see above), for
// `rows` combos, row r's tensors at its stride: tree (read), last (N+1
// entries, remapped where due), pos and cap (read, one int apart); scratch
// holds m + 2 int32 a row: the new leaves, the decision and the new pos.
extern "C" int repro_tree_lru_compact(int rows, const void* tree, long long tree_stride,
                                      void* last, long long last_stride, const void* pos,
                                      const void* cap, int window, const long long* sizes,
                                      int count, int n_items, void* scratch,
                                      long long scratch_stride, void* stream) {
  Ring r{};
  if (rows < 1 || rows > 65535 || !ring_of(sizes, count, tree, false, r) || window < 1 ||
      n_items < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows > 1 && tree_stride % 4 != 0) r.vec = 0u;  // rows off 16 bytes: scalar loads
  const int span = n_items > r.size[0] ? n_items : r.size[0];
  int blocks = (span + kCompactThreads - 1) / kCompactThreads;
  const int cap_blocks = rows > 1 ? (4096 + rows - 1) / rows : 4096;  // ~4096 blocks in all
  if (blocks > cap_blocks) blocks = cap_blocks;
  compact_kernel<<<dim3((unsigned)blocks, (unsigned)rows), kCompactThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tree), static_cast<int*>(last), static_cast<const int*>(pos),
      static_cast<const int*>(cap), window, r, n_items, static_cast<int*>(scratch), tree_stride,
      last_stride, scratch_stride);
  return (int)cudaGetLastError();
}

// One chunk of ids for `rows` combos of a grid, a block each; each tensor
// holds a row a combo (tree rows `tree_stride` apart, last `last_stride`,
// states `state_stride`, ids `ids_stride`: 0 where the combos share one
// chunk; see Rows).  state: a combo's compaction
// (decision, new pos), the decision reset to 0 once read.  flags: null, or
// one byte a request.  hits: one int32 a combo; stats: three float32
// (reward, aux, occupancy).  A single chunk is the grid of one combo.
extern "C" int repro_tree_lru_chunk(int rows, void* tree, long long tree_stride, void* last,
                                    long long last_stride, void* pos, void* nseen,
                                    const void* cap, const void* ids, long long ids_stride,
                                    int window, const long long* sizes, int count, void* state,
                                    long long state_stride, void* flags, void* hits, void* stats,
                                    void* stream) {
  Ring r{};
  if (rows < 1 || !ring_of(sizes, count, tree, true, r) || window < 1 || state == nullptr ||
      (ids_stride != 0 && ids_stride < window)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows > 1 && tree_stride % 4 != 0) r.vec = 0u;  // rows off 16 bytes: scalar loads
  const size_t smem = (size_t)r.sints * sizeof(int);
  if (smem > 0) {  // beside ~20 KB of static shared memory: past 48 KB in all
    const cudaError_t e = cudaFuncSetAttribute(
        tree_lru_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tree_lru_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(tree), static_cast<int*>(last), static_cast<int*>(pos),
      static_cast<int*>(nseen), static_cast<const int*>(cap), static_cast<const int*>(ids),
      window, r, static_cast<int*>(state), static_cast<unsigned char*>(flags),
      static_cast<int*>(hits), static_cast<float*>(stats),
      Rows{tree_stride, last_stride, state_stride, ids_stride});
  return (int)cudaGetLastError();
}
