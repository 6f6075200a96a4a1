// Batched point update of a packed radix tree: a float64 segmented sum.
//
// The reference's tree_update (src/repro/kernels/prefix_tree/ops.py) adds
// each delta[q] to every node on the ancestor path of leaf idx[q] with one
// scatter-add, outside Pallas; it is the tree's second sum beside the
// segsum levels that src/repro/kernels/prefix_tree/kernel.py's
// segsum_kernel builds.  The port's plain version (ref.py's
// tree_update_ref) sums each node's deltas in float64, in input order, and
// rounds each node once: node <- float32(float64(node) + sum_q delta[q]),
// which is what index_put_(accumulate=True) computes on the CPU (on the
// card PyTorch's accumulate sums a long run of one index across a warp).
// This kernel computes the same, bit for bit, with no global sort and no
// scratch that outlives the launch.
//
// A level (blockIdx.y) takes 1 to kMaxParts blocks of kThreads, a block a
// kKeysPerBlock of the most keys it can have (min(deltas, its nodes));
// block blockIdx.x takes the keys k with k % parts == blockIdx.x, and every
// block reads every delta.  A call's deltas (2000 in an ogb_tree or sized
// chunk) land under few nodes of a level (a few dozen to a few hundred,
// every one of them under a handful at the top) or, in an int32 tree,
// scatter over many leaves.  So a block sorts its deltas by node into runs
// and sums each run alone; the work is the deltas and the nodes they
// touch, never nodes x deltas:
//  A. Stage: each delta read once (coalesced, two a thread, every read
//     issued first): its key at this level (row * size + the leaf's node,
//     or -1 where it adds nothing) and its value; the deltas' exponents
//     decide the order of the adds (below).
//  B. Hash (linear probing, the table at most half full): a warp's lanes
//     with one key (__match_any_sync) insert it once and count its deltas
//     by one atomic; a new key takes the next slot and prefetches its tree
//     node into L2.  Then each slot's run its place: a warp's scan of its
//     slots' counts and one atomic a warp.
//  C. Scatter: each delta to its slot's run.  Where any order is exact, a
//     warp's lanes under one node take consecutive places by one shared
//     atomic.  Where the order matters, every warp finds its 32-delta
//     chunks' groups, warp 0 hands out the groups' places chunk by chunk,
//     and every warp places its deltas: each run keeps input order.
//  D. Sum each run and write its node once: read, add, round, write.  A run
//     of kLongRun or more that may add in any order takes a warp (each lane
//     its share, then the 32 sums by shuffles); every other run a thread,
//     in run order.  Nodes no delta reaches are not written.  Entries with
//     idx < 0, idx >= n, or a row outside [0, n_rows) add nothing.
//
// The workspace (per table entry a key and its slot; per delta its key,
// then its slot, its value and its place in the runs; per slot its key,
// count and run's end; the long runs' slots, or in input order each
// delta's group) lies in shared memory up to kOnChipDeltas deltas, 176 KB;
// past that in a global buffer the caller passes, in the same layout (the
// same kernel at kOnChip = false, its atomics in L2).
//
// The order of the adds.  A node's float64 sum in input order is a chain of
// dependent adds as long as its run of deltas (~1850 at the top of an
// ogb_tree chunk's trees).  But where every partial sum is exact in
// float64, every order gives the same bits: the deltas are float32, each a
// multiple of the smallest ulp u among the nonzero ones, so a partial sum of
// k of them is a multiple of u below k * max|delta|, and float64 holds every
// multiple of u up to 2^53 u.  Step A tests that bound from the deltas'
// exponents (no infinity or NaN, and count * max|delta| <= 2^53 u), for the
// whole call; then runs add in any order, else in input order.  Integer
// deltas (the count trees' +-1) always pass; float deltas pass while their
// magnitudes span under 2^18 at 2000 deltas.
//
// Stacked trees.  The sized OGB keeps K trees of one shape in one (K, TOT)
// tensor, one a size class (src/repro/cachesim/tree_engines.py:
// _stacked_tree_update).  With a `rows` array, delta q goes along the path
// of leaf idx[q] in tree rows[q]: a level's nodes are keyed row * size + node
// and written at row * TOT + the level's offset + node, so one launch
// updates every tree, as it updates one.
//
// Int32 trees.  Integer adds are exact and associative (int32 wraps alike in
// any order), so an int32 tree's deltas add in any order, in int64.
//
// Bound on an H100: the bytes, idx (and rows) and delta read once and each
// touched node read and written once (12-20 B a delta: ~0.01 us at 2000
// deltas), are no bound; the latency is: the staged read, four block
// barriers (six in input order), the node's read and write in L2, and in
// input order the longest run's chain of dependent float64 adds.

#include <climits>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps <= 32, "a warp reduces the warps' exponents, a lane each");
constexpr int kMaxLevels = 64;
constexpr int kOnChipDeltas = 4096;  // the most deltas a call stages in shared memory
constexpr int kLongRun = 32;         // a run this long adds on a warp (any order)
constexpr long long kMaxDeltas = 1LL << 29;  // the table's entries stay below 2^31
constexpr int kKeysPerBlock = 512;  // a level's distinct keys a block takes at most
constexpr int kMaxParts = 8;        // blocks a level at most
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

struct Levels {
  long long off[kMaxLevels];
  long long size[kMaxLevels];
  int parts[kMaxLevels];  // blocks the level's keys are split over (key % parts)
  int max_parts;
};

// The levels of a call of q deltas over n_rows trees of `count` levels of
// `sizes`: each level's keys split over a block for every kKeysPerBlock
// of the most it can have (min(q, n_rows * size)), at most kMaxParts.
inline Levels levels_of(const long long* sizes, int count, int n_rows, long long q) {
  Levels lv{};
  long long off = 0;
  for (int l = 0; l < count; ++l) {
    lv.off[l] = off;
    lv.size[l] = sizes[l];
    off += sizes[l];
    const long long keys = q < n_rows * sizes[l] ? q : n_rows * sizes[l];
    const long long parts = (keys + kKeysPerBlock - 1) / kKeysPerBlock;
    lv.parts[l] = (int)(parts < 1 ? 1 : parts > kMaxParts ? kMaxParts : parts);
    lv.max_parts = lv.parts[l] > lv.max_parts ? lv.parts[l] : lv.max_parts;
  }
  return lv;
}

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

// log2 of the hash table's entries for q deltas: at least twice q (so the
// table is at most half full) and at least one entry a thread.
__host__ __device__ inline int table_bits(long long q) {
  int b = 10;
  while ((1LL << b) < 2 * q) ++b;
  return b;
}

// A level's workspace in bytes: 2 words a table entry, 7 a delta.
__host__ __device__ inline long long work_bytes(long long q, int bits) {
  return 4 * (2 * (1LL << bits) + 7 * q);
}

// Where delta p lands at this level.
template <typename Index>
struct Keys {
  const Index* __restrict__ idx;
  const Index* __restrict__ rows;  // null: one tree
  long long n;
  int n_rows;
  int sh;
  int size;  // this level's nodes a tree
  long long off;
  long long row_stride;

  // row * size + the leaf's node, or -1 if it adds nothing (a leaf past
  // the leaves, a row past the rows); both reads issued first
  __device__ __forceinline__ int key_of(int p) const {
    const long long leaf = (long long)__ldg(idx + p);
    const long long row = rows != nullptr ? (long long)__ldg(rows + p) : 0;
    if (leaf < 0 || leaf >= n || row < 0 || row >= n_rows) return -1;
    return (int)(row * size + (leaf >> sh));
  }
  // the tree offset of key k: row k / size, node k % size
  __device__ __forceinline__ long long at(int key) const {
    const int row = key / size;
    return row * row_stride + off + (key - row * size);
  }
};

// The table entry of `key`, inserted if new (`fresh`).
__device__ __forceinline__ int insert(int* tkey, int bits, int key, bool& fresh) {
  const unsigned mask = (1u << bits) - 1u;
  for (unsigned h = ((unsigned)key * 2654435769u) >> (32 - bits);; h = (h + 1u) & mask) {
    const int k = atomicCAS(tkey + h, -1, key);
    if (k == -1 || k == key) {
      fresh = k == -1;
      return (int)h;
    }
  }
}

template <typename T, typename Index, bool kOnChip>
__global__ void __launch_bounds__(kThreads)
tree_update_kernel(T* __restrict__ tree, long long n, int shift, Levels lv,
                   const Index* __restrict__ idx, const Index* __restrict__ rows, int n_rows,
                   long long row_stride, const T* __restrict__ delta, int q, int bits,
                   unsigned char* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_slots, n_long, placed, warp_lo[kWarps], warp_hi[kWarps];
  __shared__ unsigned warp_count[kWarps];
  using A = typename Acc<T>::type;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int level = (int)blockIdx.y;
  const int parts = lv.parts[level], part = (int)blockIdx.x;
  if (part >= parts) return;
  const int table = 1 << bits;
  const Keys<Index> keys{idx, rows, n, n_rows, shift * level, (int)lv.size[level],
                         lv.off[level], row_stride};
  int* base;
  if constexpr (kOnChip) {
    base = reinterpret_cast<int*>(smem);
  } else {
    base = reinterpret_cast<int*>(
        work + ((long long)level * lv.max_parts + part) * work_bytes(q, bits));
  }
  int* tkey = base;                                // [table] key, or -1
  int* tslot = base + table;                       // [table] slot + 1, or 0
  int* slot_of = base + 2 * table;                 // [q] delta's key, then its slot, or -1
  T* val = reinterpret_cast<T*>(slot_of + q);      // [q] delta's value
  T* run = reinterpret_cast<T*>(slot_of + 2 * q);  // [q] the values, by slot
  int* skey = slot_of + 3 * q;                     // [slots] key
  int* scount = slot_of + 4 * q;                   // [slots] deltas
  int* send = slot_of + 5 * q;                     // [slots] run's start, then end
  int* longs = slot_of + 6 * q;                    // any order: [n_long] long runs' slots;
  int* group = longs;                              // input order: [q] a delta's group

  // A. stage: each delta's key and value, two positions a thread at a
  // time, every read issued first; the deltas' exponents and count; the
  // empty table
  int my_lo = 255, my_hi = 0;
  unsigned my_count = 0;
  auto stage = [&](int p, int key, T v) {
    slot_of[p] = key >= 0 && key % parts == part ? key : -1;  // this block's keys
    val[p] = v;
    if (key >= 0) {
      ++my_count;
      if constexpr (std::is_same<T, float>::value) {  // float deltas: their exponents
        const unsigned v_bits = __float_as_uint(v);
        const int e = (int)((v_bits >> 23) & 0xffu);  // 255: infinity or NaN
        if ((v_bits & 0x7fffffffu) != 0) {
          my_lo = min(my_lo, max(e, 1));  // a subnormal's ulp is the smallest normal's
          my_hi = max(my_hi, e);
        }
      }
    }
  };
  for (int p = threadIdx.x; p < q; p += 2 * kThreads) {
    const bool two = p + kThreads < q;
    const int key0 = keys.key_of(p), key1 = two ? keys.key_of(p + kThreads) : -1;
    const T v0 = __ldg(delta + p), v1 = two ? __ldg(delta + p + kThreads) : (T)0;
    stage(p, key0, v0);
    if (two) stage(p + kThreads, key1, v1);
  }
  for (int e = threadIdx.x; e < table; e += kThreads) {
    tkey[e] = -1;
    tslot[e] = 0;
  }
  my_lo = __reduce_min_sync(kFull, my_lo);
  my_hi = __reduce_max_sync(kFull, my_hi);
  my_count = __reduce_add_sync(kFull, my_count);
  if (lane == 0) {
    warp_lo[warp] = my_lo;
    warp_hi[warp] = my_hi;
    warp_count[warp] = my_count;
  }
  if (threadIdx.x == 0) {
    n_slots = 0;
    n_long = 0;
    placed = 0;
  }
  __syncthreads();
  // float: max|delta| < 2^(hi - 126), u = 2^(lo - 150): exact while
  // count * 2^(hi - 126) <= 2^53 * 2^(lo - 150); int32: always
  const int lo = __reduce_min_sync(kFull, lane < kWarps ? warp_lo[lane] : 255);
  const int hi = __reduce_max_sync(kFull, lane < kWarps ? warp_hi[lane] : 0);
  const unsigned count = __reduce_add_sync(kFull, lane < kWarps ? warp_count[lane] : 0u);
  const int log2_count = count > 1 ? 32 - __clz((int)(count - 1)) : 0;
  const bool exact = !std::is_same<T, float>::value || (hi < 255 && hi - lo <= 29 - log2_count);

  // B. hash and count: a warp's lanes with one key insert it once; a new
  // key takes the next slot, published once it holds its key and count,
  // and prefetches its tree node into L2; then each slot's run its place,
  // by a warp's scan of the counts and one atomic a warp
  for (int b = 0; b < q; b += kThreads) {
    const int p = b + threadIdx.x;
    const int key = p < q ? slot_of[p] : -1;
    const unsigned peers = __match_any_sync(kFull, key);
    const int leader = __ffs(peers) - 1;
    int slot = -1;
    if (key >= 0 && lane == leader) {
      bool fresh;
      const int h = insert(tkey, bits, key, fresh);
      if (fresh) {
        slot = atomicAdd(&n_slots, 1);
        skey[slot] = key;
        scount[slot] = __popc(peers);
        __threadfence_block();
        tslot[h] = slot + 1;
        asm volatile("prefetch.L2 [%0];" ::"l"(tree + keys.at(key)));
      } else {
        const volatile int* published = tslot;
        while ((slot = published[h] - 1) < 0) {
        }
        atomicAdd(scount + slot, __popc(peers));
      }
    }
    slot = __shfl_sync(kFull, slot, leader);
    if (p < q) slot_of[p] = slot;
  }
  __syncthreads();
  const int slots = n_slots;
  for (int b = 0; b < slots; b += kThreads) {
    const int slot = b + threadIdx.x;
    const int c = slot < slots ? scount[slot] : 0;
    int upto = c;  // the warp's inclusive scan of the counts
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, upto, o);
      if (lane >= o) upto += y;
    }
    int first = 0;
    if (lane == 31) first = atomicAdd(&placed, upto);
    first = __shfl_sync(kFull, first, 31) + upto - c;
    if (slot < slots) {
      send[slot] = first;
      if (exact && c >= kLongRun) longs[atomicAdd(&n_long, 1)] = slot;
    }
  }
  __syncthreads();

  // C. each delta to its slot's run.  A warp's lanes under one node take
  // consecutive places: any order, by one atomic; in input order, a chunk
  // of 32 deltas at a time, its groups found by every warp at once, their
  // places handed out by warp 0 in chunk order, the deltas placed by all
  if (exact) {
    for (int b = 0; b < q; b += kThreads) {
      const int p = b + threadIdx.x;
      const int slot = p < q ? slot_of[p] : -1;
      const unsigned peers = __match_any_sync(kFull, slot);
      const int leader = __ffs(peers) - 1;
      int dst = 0;
      if (slot >= 0 && lane == leader) dst = atomicAdd(send + slot, __popc(peers));
      dst = __shfl_sync(kFull, dst, leader) + __popc(peers & below);
      if (slot >= 0) run[dst] = val[p];
    }
  } else {
    for (int b = 0; b < q; b += kThreads) {
      const int p = b + threadIdx.x;
      const int slot = p < q ? slot_of[p] : -1;
      const unsigned peers = __match_any_sync(kFull, slot);
      if (p < q) {  // rank in the group, the leader's lane, the group's size
        group[p] = slot < 0 ? -1 : __popc(peers & below) | (__ffs(peers) - 1) << 5 |
                                       __popc(peers) << 10;
      }
    }
    __syncthreads();
    if (warp == 0) {  // leaders take their group's places in chunk order: slot_of <- the first
#pragma unroll 4
      for (int b = 0; b < q; b += 32) {
        const int p = b + lane;
        const int g = p < q ? group[p] : -1;
        if (g >= 0 && (g & 31) == 0) {
          const int slot = slot_of[p];
          const int place = send[slot];
          send[slot] = place + (g >> 10);
          slot_of[p] = place;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < q; p += kThreads) {
      const int g = group[p];
      if (g >= 0) run[slot_of[(p & ~31) + ((g >> 5) & 31)] + (g & 31)] = val[p];
    }
  }
  __syncthreads();

  // D. each run summed, its node written once (the node read first, its
  // wait behind the sum): a long run that may add in any order on a warp
  // (each lane its share, then the 32 sums by shuffles), every other run
  // on a thread, in run order
  if (exact) {
    for (int i = warp; i < n_long; i += kWarps) {
      const int slot = longs[i];
      const int end = send[slot];
      const long long a = keys.at(skey[slot]);
      const T node = lane == 0 ? tree[a] : (T)0;
      A sum = 0;
      for (int j = end - scount[slot] + lane; j < end; j += 32) sum = Acc<T>::add(sum, (A)run[j]);
      for (int o = 16; o > 0; o >>= 1) sum = Acc<T>::add(sum, __shfl_xor_sync(kFull, sum, o));
      if (lane == 0) tree[a] = Acc<T>::store(node, sum);
    }
  }
  for (int slot = threadIdx.x; slot < slots; slot += kThreads) {
    const int c = scount[slot];
    if (exact && c >= kLongRun) continue;
    const int end = send[slot];
    const long long a = keys.at(skey[slot]);
    const T node = tree[a];
    A sum = 0;
#pragma unroll 8
    for (int j = end - c; j < end; ++j) sum = Acc<T>::add(sum, (A)run[j]);
    tree[a] = Acc<T>::store(node, sum);
  }
}

// Lets the on-chip kernel take the largest workspace, once a device (not
// again while a CUDA graph captures the launch).
template <typename T, typename Index>
cudaError_t allow_on_chip() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && done[dev])) return e;
  e = cudaFuncSetAttribute(tree_update_kernel<T, Index, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)work_bytes(kOnChipDeltas, table_bits(kOnChipDeltas)));
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

template <typename T, typename Index>
int launch(T* tree, long long n, int count, int shift, const Levels& lv, const Index* idx,
           const Index* rows, int n_rows, long long row_stride, const T* delta, int q,
           void* work, cudaStream_t s) {
  const dim3 grid((unsigned)lv.max_parts, (unsigned)count);
  const int bits = table_bits(q);
  if (q <= kOnChipDeltas) {
    const cudaError_t e = allow_on_chip<T, Index>();
    if (e != cudaSuccess) return (int)e;
    const int smem = (int)work_bytes(q, bits);
    tree_update_kernel<T, Index, true><<<grid, kThreads, smem, s>>>(
        tree, n, shift, lv, idx, rows, n_rows, row_stride, delta, q, bits, nullptr);
  } else {
    if (work == nullptr) return (int)cudaErrorInvalidValue;
    tree_update_kernel<T, Index, false><<<grid, kThreads, 0, s>>>(
        tree, n, shift, lv, idx, rows, n_rows, row_stride, delta, q, bits,
        static_cast<unsigned char*>(work));
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_by_index(void* tree, long long n, int count, int shift, const Levels& lv,
                    const void* idx, const void* rows, int idx_bytes, int n_rows,
                    long long row_stride, const void* delta, int q, void* work, cudaStream_t s) {
  T* t = static_cast<T*>(tree);
  const T* d = static_cast<const T*>(delta);
  if (idx_bytes == 4) {
    return launch<T, int>(t, n, count, shift, lv, static_cast<const int*>(idx),
                          static_cast<const int*>(rows), n_rows, row_stride, d, q, work, s);
  }
  return launch<T, long long>(t, n, count, shift, lv, static_cast<const long long*>(idx),
                              static_cast<const long long*>(rows), n_rows, row_stride, d, q,
                              work, s);
}

}  // namespace

// Bytes of the global workspace a call of q_count deltas over n_rows trees
// of `count` levels of `sizes` needs: 0 where it stages in shared memory.
extern "C" long long repro_tree_update_work_bytes(long long q_count, const long long* sizes,
                                                  int count, int n_rows) {
  if (q_count <= kOnChipDeltas) return 0;
  return (long long)count * levels_of(sizes, count, n_rows, q_count).max_parts *
         work_bytes(q_count, table_bits(q_count));
}

// Add delta[q] (float32, or int32 when is_int) along the ancestor path of
// leaf idx[q] (int32 when idx_bytes is 4, else int64) for q < q_count (at
// most 2^29), in a tree of `count` levels of `sizes` (leaves first; radix
// 2^shift); with `rows` (idx's type; null for one tree), in tree rows[q] of
// n_rows trees of one shape, row_stride nodes apart (n_rows * sizes[0]
// below 2^31).  `work`: a global buffer of repro_tree_update_work_bytes
// bytes, any contents (null where that is 0).
extern "C" int repro_tree_update(void* tree, int is_int, const long long* sizes, int count,
                                 int shift, const void* idx, const void* rows, int idx_bytes,
                                 int n_rows, long long row_stride, const void* delta,
                                 long long q_count, void* work, void* stream) {
  if (count < 1 || count > kMaxLevels || shift < 1 || q_count < 1 || q_count > kMaxDeltas ||
      n_rows < 1 || (long long)n_rows * sizes[0] > INT_MAX ||
      (idx_bytes != 4 && idx_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const Levels lv = levels_of(sizes, count, n_rows, q_count);
  if (n_rows > 1 && row_stride < lv.off[count - 1] + sizes[count - 1]) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q = (int)q_count;
  return is_int ? launch_by_index<int>(tree, sizes[0], count, shift, lv, idx, rows, idx_bytes,
                                       n_rows, row_stride, delta, q, work, s)
                : launch_by_index<float>(tree, sizes[0], count, shift, lv, idx, rows, idx_bytes,
                                         n_rows, row_stride, delta, q, work, s);
}
