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
//   256-request sub-chunk, the sub-chunks in order.  A thread finds its
//   request's previous one in the sub-chunk (a scan of the sub-chunk's ids
//   in shared memory) or else reads last[j]; its reuse distance is the tree's
//   marks after that position (the tree's total less a prefix count: a
//   node's left siblings, level by level) plus the dominance term: the
//   requests of the sub-chunk between the two whose own previous request
//   lies at or before it (each a distinct item not yet counted), counted in
//   shared memory.  After a barrier each item's mark moves once: the first
//   request of an item removes its old mark, the last inserts one at its
//   position, by integer atomicAdd along the leaf's path, exact in any
//   order; the tree's total is kept in a register.
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
// Bound on an H100: bytes, the ids read and each distinct item's last read
// and written, and the tree nodes on the marks' paths, take a few
// microseconds at a 1e6-request chunk; the chunk kernel is latency-bound, a
// chain of dependent sub-chunks, each a shared-memory scan of 256 ids, a
// prefix read of ~5 levels through L2 and a path of atomics.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kShift = 4;  // radix 16
constexpr int kRadix = 1 << kShift;
constexpr int kThreads = 256;  // a sub-chunk: one thread a request
constexpr int kMaxLevels = 8;  // a ring below 2^30 positions
constexpr int kCompactThreads = 256;

struct Ring {
  long long off[kMaxLevels];
  int size[kMaxLevels];
  int count;
};

// Marks at positions [0, p], p >= 0: at the leaves the group's children up
// to p, above each node's left siblings.  The reads of every level are
// independent (predicated and unrolled, all in flight at once); __ldcg reads
// them from L2, where the block's atomics land.
__device__ __forceinline__ int prefix_count(const int* __restrict__ tree, const Ring& r, int p) {
  int acc = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < r.count) {
      const int node = p >> (kShift * l);
      const int grp = node & ~(kRadix - 1);
      const int last = l == 0 ? node : node - 1;
      const int* lev = tree + r.off[l];
#pragma unroll
      for (int k = 0; k < kRadix; ++k) {
        if (grp + k <= last) acc += __ldcg(lev + grp + k);
      }
    }
  }
  return acc;
}

// Adds delta to the leaf at position q and to each of its ancestors.
__device__ __forceinline__ void add_path(int* __restrict__ tree, const Ring& r, int q,
                                         int delta) {
  for (int l = 0; l < r.count; ++l) {
    atomicAdd(tree + r.off[l] + q, delta);
    q >>= kShift;
  }
}

// The marks in the tree: the sum of its top level (at most 16 nodes).
__device__ __forceinline__ int total_marks(const int* __restrict__ tree, const Ring& r) {
  const int top = r.count - 1;
  int total = 0;
  for (int k = 0; k < r.size[top]; ++k) total += __ldcg(tree + r.off[top] + k);
  return total;
}

__global__ void __launch_bounds__(kCompactThreads)
    compact_kernel(const int* __restrict__ tree, int* __restrict__ last,
                   const int* __restrict__ pos, const int* __restrict__ cap, int window, Ring r,
                   int n_items, int* __restrict__ scratch) {
  const int m = r.size[0];
  const bool due = (long long)*pos + window > m;
  const int nmarks = total_marks(tree, r);
  const int kept = min(nmarks, *cap);
  const int dropped = nmarks - kept;
  const int span = max(n_items, m);
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < span; t += gridDim.x * blockDim.x) {
    if (due && t < n_items) {
      const int q = last[t];
      if (q >= 0) {
        const int rank = prefix_count(tree, r, q) - 1 - dropped;
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

__global__ void __launch_bounds__(kThreads)
    tree_lru_kernel(int* __restrict__ tree, int* __restrict__ last, int* __restrict__ pos,
                    int* __restrict__ nseen, const int* __restrict__ cap,
                    const int* __restrict__ ids, int window, Ring r,
                    const int* __restrict__ state, unsigned char* __restrict__ flags,
                    int* __restrict__ hits_out, float* __restrict__ stats) {
  __shared__ int s_ids[kThreads];
  __shared__ int s_prev[kThreads];
  __shared__ int s_moved[2];  // marks inserted, marks removed, this sub-chunk
  __shared__ int s_count[2];  // hits, requests that found no mark
  const int tid = threadIdx.x;
  const int m = r.size[0];
  int p0 = *pos;
  if (state != nullptr && state[0]) p0 = state[1];
  const int c = *cap;
  const int seen0 = *nseen;
  if ((long long)p0 + window > m) {  // the caller's bound was wrong: touch nothing
    if (tid == 0) {
      *hits_out = INT_MIN;
      stats[0] = stats[1] = stats[2] = __int_as_float(0x7fc00000);
    }
    return;
  }
  int total = total_marks(tree, r);
  int hits = 0, unseen = 0;
  if (tid < 2) s_count[tid] = 0;

  for (int base = 0; base < window; base += kThreads) {
    const int n = min(kThreads, window - base);
    const int at = p0 + base;  // the sub-chunk's first position
    const int j = tid < n ? __ldg(ids + base + tid) : -1;
    s_ids[tid] = j;
    __syncthreads();
    int prev_in = -1, lastg = -1, prevp = -1;
    bool final = true;
    if (tid < n) {
      for (int k = 0; k < n; ++k) {
        if (s_ids[k] == j) {
          if (k < tid) prev_in = k;
          final &= k <= tid;
        }
      }
      lastg = __ldcg(last + j);
      prevp = prev_in >= 0 ? at + prev_in : lastg;
      s_prev[tid] = prevp;
    }
    if (tid < 2) s_moved[tid] = 0;
    __syncthreads();
    if (tid < n) {
      bool hit = false;
      if (prevp >= 0) {
        // marks after prevp before the sub-chunk, then the sub-chunk's
        // requests between the two whose previous request is at or before it
        int d = prevp >= at ? 0 : total - prefix_count(tree, r, prevp);
        for (int k = max(prevp - at + 1, 0); k < tid; ++k) d += s_prev[k] <= prevp;
        hit = d <= c - 1;
      } else {
        ++unseen;
      }
      hits += hit;
      if (flags != nullptr) flags[base + tid] = hit;
    }
    __syncthreads();  // every read of the tree and of last is done
    if (tid < n) {
      if (lastg >= 0 && prev_in < 0) {
        add_path(tree, r, lastg, -1);
        atomicAdd(&s_moved[1], 1);
      }
      if (final) {
        add_path(tree, r, at + tid, 1);
        last[j] = at + tid;
        atomicAdd(&s_moved[0], 1);
      }
    }
    __syncthreads();
    total += s_moved[0] - s_moved[1];
  }

  atomicAdd(&s_count[0], hits);
  atomicAdd(&s_count[1], unseen);
  __syncthreads();
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

bool ring_of(const long long* sizes, int count, Ring& r) {
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
  return true;
}

}  // namespace

// The compaction a chunk of `window` requests may need (see above): tree
// (read), last (N+1 entries, remapped where due), pos and cap (read);
// scratch holds m + 2 int32: the new leaves, the decision and the new pos.
extern "C" int repro_tree_lru_compact(const void* tree, void* last, const void* pos,
                                      const void* cap, int window, const long long* sizes,
                                      int count, int n_items, void* scratch, void* stream) {
  Ring r{};
  if (!ring_of(sizes, count, r) || window < 1 || n_items < 1) return (int)cudaErrorInvalidValue;
  const int span = n_items > r.size[0] ? n_items : r.size[0];
  int blocks = (span + kCompactThreads - 1) / kCompactThreads;
  if (blocks > 4096) blocks = 4096;
  compact_kernel<<<blocks, kCompactThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tree), static_cast<int*>(last), static_cast<const int*>(pos),
      static_cast<const int*>(cap), window, r, n_items, static_cast<int*>(scratch));
  return (int)cudaGetLastError();
}

// One chunk.  state: null, or the compaction's (decision, new pos).  flags:
// null, or one byte a request.  hits: one int32; stats: three float32
// (reward, aux, occupancy).
extern "C" int repro_tree_lru_chunk(void* tree, void* last, void* pos, void* nseen,
                                    const void* cap, const void* ids, int window,
                                    const long long* sizes, int count, const void* state,
                                    void* flags, void* hits, void* stats, void* stream) {
  Ring r{};
  if (!ring_of(sizes, count, r) || window < 1) return (int)cudaErrorInvalidValue;
  tree_lru_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(tree), static_cast<int*>(last), static_cast<int*>(pos),
      static_cast<int*>(nseen), static_cast<const int*>(cap), static_cast<const int*>(ids),
      window, r, static_cast<const int*>(state), static_cast<unsigned char*>(flags),
      static_cast<int*>(hits), static_cast<float*>(stats));
  return (int)cudaGetLastError();
}
