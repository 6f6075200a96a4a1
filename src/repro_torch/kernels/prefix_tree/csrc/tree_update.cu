// Batched point update of a packed radix tree: a float64 segmented sum.
//
// The reference's tree_update (src/repro/kernels/prefix_tree/ops.py) adds
// each delta[q] to every node on the ancestor path of leaf idx[q] with one
// scatter-add, outside Pallas; it is the tree's second sum beside the
// segsum levels that src/repro/kernels/prefix_tree/kernel.py's
// segsum_kernel builds.  The port's plain version (ref.py's
// tree_update_ref) sums each node's deltas in float64, in input order, and
// rounds each node once: node <- float32(float64(node) + sum_q delta[q]),
// which is what index_put_(accumulate=True) computes on the CPU and, after
// a stable sort, on the card.  This kernel computes the same, bit for bit,
// with no sort.  The deltas of one call are few (2 B = 2000 in an ogb_tree
// chunk) and land under few nodes (a few dozen buckets, and all of them
// under one or two nodes of the top level), so a node's deltas are a long
// run to be summed by many threads.
//
// One block of kThreads a level (blockIdx.y), in three steps:
//  1. Each delta's node of the level; the first delta under each node
//     (its head) by atomicMin of the delta's position into `first`, a
//     scratch of one int32 a tree node that holds INT_MAX between calls (a
//     warp's lanes under one node make one atomic, __match_any_sync); and
//     whether the deltas' float64 sums are exact in any order (below).
//  2. The heads, a window of kHeads positions at a time, into a list in
//     shared memory.
//  3. A warp a head: its 32 lanes read 32 consecutive deltas at a time,
//     coalesced, and sum those under the head's node.  Lane 0 writes the
//     node once and puts INT_MAX back into its `first`.  Nodes no delta
//     reaches are not written.  Entries with idx < 0 (and ids past the
//     leaves) add nothing.
//
// The order of the adds.  A node's float64 sum in input order is a chain of
// dependent adds as long as its run of deltas (~1850 at the top of an
// ogb_tree chunk's trees).  But where every partial sum is exact in
// float64, every order gives the same bits: the deltas are float32, each a
// multiple of the smallest ulp u among the nonzero ones, so a partial sum of
// k of them is a multiple of u below k * max|delta|, and float64 holds every
// multiple of u up to 2^53 u.  Step 1 tests that bound from the deltas'
// exponents (no infinity or NaN, and count * max|delta| <= 2^53 u); then
// each lane sums its own deltas and the warp adds the 32 sums by shuffles.
// Otherwise the warp adds the deltas under the node one by one in input
// order (a ballot of the 32, then their values by shuffle, in lane order).
// Integer deltas (the count trees' +-1) always pass; float deltas pass
// while their magnitudes span under 2^18 at 2000 deltas.
//
// Stacked trees.  The sized OGB keeps K trees of one shape in one (K, TOT)
// tensor, one a size class (src/repro/cachesim/tree_engines.py:
// _stacked_tree_update).  With a `rows` array, delta q goes along the path
// of leaf idx[q] in tree rows[q]: a level's nodes are keyed row * size + node
// and written at row * TOT + the level's offset + node, so one launch
// updates every tree, as it updates one.
//
// Int32 trees.  Integer adds are exact and associative (int32 wraps alike in
// any order), so an int32 tree's deltas always take the any-order walk.
//
// Bound on an H100: the bytes, idx (and rows) and delta read once and each
// touched node read and written once (12-20 B a delta: ~0.01 us at 2000
// deltas), are no bound; the latency is: a few dependent trips to L2 and a
// walk of the deltas 32 at a time (any order), or one chain of dependent
// adds as long as a node's run (input order).  `first` makes two launches
// on one device unsafe at once; the port launches on one stream.

#include <climits>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 8192;  // head positions a round of step 3 lists: 32 KB
constexpr int kSteps = 4;     // 32-delta steps a walk loads before it adds
constexpr int kMaxLevels = 64;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  long long off[kMaxLevels];
  long long size[kMaxLevels];
};

// What a tree's values add in: float32 nodes in float64, int32 in int64.
template <typename T>
struct Acc;
template <>
struct Acc<float> {
  using type = double;
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static float store(float node, double s) {
    return __double2float_rn(__dadd_rn((double)node, s));
  }
};
template <>
struct Acc<int> {
  using type = long long;
  __device__ static long long add(long long a, long long b) { return a + b; }
  __device__ static int store(int node, long long s) {
    return (int)(unsigned)((unsigned long long)(long long)node + (unsigned long long)s);
  }
};

// Where delta p lands at this level: row * size + the leaf's node, or -1 if
// it adds nothing (a leaf past the leaves, a row past the rows).
template <typename Index>
struct Target {
  const Index* __restrict__ idx;
  const Index* __restrict__ rows;  // null: one tree
  long long n;
  int n_rows;
  int sh;
  long long size;  // this level's nodes a tree

  __device__ __forceinline__ int node_of(long long p) const {
    const long long leaf = (long long)__ldg(idx + p);
    if (leaf < 0 || leaf >= n) return -1;
    long long row = 0;
    if (rows != nullptr) {
      row = (long long)__ldg(rows + p);
      if (row < 0 || row >= n_rows) return -1;
    }
    return (int)(row * size + (leaf >> sh));
  }
};

// The deltas from q0 on under `node`, summed by the warp: any order (each
// lane its own, then the 32 by shuffles) when exact, else input order.  All
// lanes get the sum.
template <bool kExact, typename T, typename Index>
__device__ typename Acc<T>::type walk(const Target<Index>& tg, const T* __restrict__ delta,
                                      long long q_count, int node, long long q0, int lane) {
  using A = typename Acc<T>::type;
  A s = 0;
  for (long long base = q0; base < q_count; base += 32 * kSteps) {
    A v[kSteps];
    bool under[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const long long p = base + 32 * u + lane;
      under[u] = p < q_count && tg.node_of(p) == node;
      v[u] = under[u] ? (A)__ldg(delta + p) : (A)0;
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (kExact) {
        s = Acc<T>::add(s, v[u]);
      } else {
        unsigned bits = __ballot_sync(kFull, under[u]);  // in lane order
        while (bits) {
          const int j = __ffs(bits) - 1;
          bits &= bits - 1;
          s = Acc<T>::add(s, __shfl_sync(kFull, v[u], j));
        }
      }
    }
  }
  if (kExact) {
    for (int o = 16; o > 0; o >>= 1) s = Acc<T>::add(s, __shfl_xor_sync(kFull, s, o));
  }
  return s;
}

template <typename T, typename Index>
__global__ void __launch_bounds__(kThreads)
tree_update_kernel(T* __restrict__ tree, long long n, int shift, Levels lv,
                   const Index* __restrict__ idx, const Index* __restrict__ rows, int n_rows,
                   long long row_stride, const T* __restrict__ delta, long long q_count,
                   int* __restrict__ first) {
  __shared__ int heads[kHeads];
  __shared__ int n_heads, lo, hi;
  __shared__ unsigned count;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int level = (int)blockIdx.y;
  const Target<Index> tg{idx, rows, n, n_rows, shift * level, lv.size[level]};
  // node key k of this level: row k / size, node k % size, at tree offset
  // row * row_stride + off + node (`first` has the tree's layout)
  auto at = [&](int key) {
    const long long row = key / tg.size;
    return row * row_stride + lv.off[level] + (key - row * tg.size);
  };
  if (threadIdx.x == 0) {
    lo = 255;
    hi = 0;
    count = 0;
  }
  __syncthreads();

  // 1. heads by atomicMin; the deltas' exponents and count
  int my_lo = 255, my_hi = 0;
  unsigned my_count = 0;
  for (long long q0 = 0; q0 < q_count; q0 += kThreads) {
    const long long q = q0 + threadIdx.x;
    int node = -1;
    if (q < q_count) {
      node = tg.node_of(q);
      if (node >= 0) {
        ++my_count;
        if constexpr (std::is_same<T, float>::value) {  // float deltas: their exponents
          const unsigned bits = __float_as_uint(__ldg(delta + q));
          const int e = (int)((bits >> 23) & 0xffu);  // 255: infinity or NaN
          if ((bits & 0x7fffffffu) != 0) {
            my_lo = min(my_lo, max(e, 1));  // a subnormal's ulp is the smallest normal's
            my_hi = max(my_hi, e);
          }
        }
      }
    }
    // lanes hold ascending positions: a group's first lane holds its least
    const unsigned peers = __match_any_sync(kFull, node);
    if (node >= 0 && lane == __ffs(peers) - 1) atomicMin(first + at(node), (int)q);
  }
  my_lo = __reduce_min_sync(kFull, my_lo);
  my_hi = __reduce_max_sync(kFull, my_hi);
  my_count = __reduce_add_sync(kFull, my_count);
  if (lane == 0) {
    atomicMin(&lo, my_lo);
    atomicMax(&hi, my_hi);
    atomicAdd(&count, my_count);
  }
  __syncthreads();
  // float: max|delta| < 2^(hi - 126), u = 2^(lo - 150): exact while
  // count * 2^(hi - 126) <= 2^53 * 2^(lo - 150); int32: always
  const int log2_count = count > 1 ? 32 - __clz((int)(count - 1)) : 0;
  const bool exact = !std::is_same<T, float>::value || (hi < 255 && hi - lo <= 29 - log2_count);

  for (long long w0 = 0; w0 < q_count; w0 += kHeads) {
    // 2. this window's heads (their atomics are done: step 1 ended in a barrier)
    if (threadIdx.x == 0) n_heads = 0;
    __syncthreads();
    const long long w1 = min(q_count, w0 + kHeads);
    for (long long q = w0 + threadIdx.x; q < w1; q += kThreads) {
      const int node = tg.node_of(q);
      if (node >= 0 && __ldcg(first + at(node)) == (int)q) heads[atomicAdd(&n_heads, 1)] = (int)q;
    }
    __syncthreads();
    // 3. a warp a head; a later window's deltas under the node read INT_MAX
    // or the head's position from `first`, never their own
    for (int h = warp; h < n_heads; h += kWarps) {
      const long long q = heads[h];
      const int node = tg.node_of(q);
      const auto s = exact ? walk<true, T>(tg, delta, q_count, node, q, lane)
                           : walk<false, T>(tg, delta, q_count, node, q, lane);
      if (lane == 0) {
        const long long a = at(node);
        tree[a] = Acc<T>::store(tree[a], s);
        first[a] = INT_MAX;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(void* tree, long long n, int count, int shift, const Levels& lv, const void* idx,
           const void* rows, int idx_bytes, int n_rows, long long row_stride, const void* delta,
           long long q_count, void* first, cudaStream_t s) {
  const dim3 grid(1, (unsigned)count);
  T* t = static_cast<T*>(tree);
  const T* d = static_cast<const T*>(delta);
  int* f = static_cast<int*>(first);
  if (idx_bytes == 4) {
    tree_update_kernel<T, int><<<grid, kThreads, 0, s>>>(
        t, n, shift, lv, static_cast<const int*>(idx), static_cast<const int*>(rows), n_rows,
        row_stride, d, q_count, f);
  } else {
    tree_update_kernel<T, long long><<<grid, kThreads, 0, s>>>(
        t, n, shift, lv, static_cast<const long long*>(idx), static_cast<const long long*>(rows),
        n_rows, row_stride, d, q_count, f);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Add delta[q] (float32, or int32 when is_int) along the ancestor path of
// leaf idx[q] (int32 when idx_bytes is 4, else int64) for q < q_count (below
// 2^31), in a tree of `count` levels of `sizes` (leaves first; radix
// 2^shift); with `rows` (idx's type; null for one tree), in tree rows[q] of
// n_rows trees of one shape, row_stride nodes apart (n_rows * sizes[0]
// below 2^31).  `first` holds an int32 a node of every tree, INT_MAX on
// entry, and is left so.
extern "C" int repro_tree_update(void* tree, int is_int, const long long* sizes, int count,
                                 int shift, const void* idx, const void* rows, int idx_bytes,
                                 int n_rows, long long row_stride, const void* delta,
                                 long long q_count, void* first, void* stream) {
  if (count < 1 || count > kMaxLevels || shift < 1 || q_count < 1 || q_count > INT_MAX ||
      n_rows < 1 || (long long)n_rows * sizes[0] > INT_MAX ||
      (idx_bytes != 4 && idx_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv{};
  long long off = 0;
  for (int l = 0; l < count; ++l) {
    lv.off[l] = off;
    lv.size[l] = sizes[l];
    off += sizes[l];
  }
  if (n_rows > 1 && row_stride < off) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_int ? launch<int>(tree, sizes[0], count, shift, lv, idx, rows, idx_bytes, n_rows,
                              row_stride, delta, q_count, first, s)
                : launch<float>(tree, sizes[0], count, shift, lv, idx, rows, idx_bytes, n_rows,
                                row_stride, delta, q_count, first, s);
}
