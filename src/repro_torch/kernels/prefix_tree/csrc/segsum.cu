// The sums of a packed radix tree: one level, and the whole tree in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/prefix_tree/kernel.py
// (segsum_kernel, launched by block_segment_sums once a level of the
// reference's tree_build).  That kernel pads the child level on the host to
// whole (block_rows, radix) tiles; here the ragged last group is zero-padded
// inside the kernel: a child index at or past the level's size reads as 0.
//
// Every node is summed the same way, by one warp: lane l sums children
// l, l + 32, ... in order, then the warp reduces by shuffles in a fixed
// pattern (node_sum below), each level from the float32 level below.  So
// the result is the same on every run, equal bit for bit between the two
// kernels, and exact for integer-valued inputs below 2^24.
//
// * repro_segsum: one level, one warp a node (block_segment_sums).  Bound on
//   an H100 (3.35 TB/s): bytes, 4 B a child read and 4 B a node written:
//   4.06 MB, 1.2 us, at 1e6 children -> 15 625 nodes (radix 64).
// * repro_tree_build: the whole flat tree in one launch (tree_build), where
//   the per-level design took a launch a level and a concatenation.  A block
//   owns a tile of radix^d leaves (the largest power that fits kTileLeaves:
//   4096 leaves at radix 64, d = 2).  It reads its leaves once, 16 bytes a
//   load and every load of a thread in flight before the first store (the
//   card needs ~15 KB in flight an SM to stream), into shared memory and
//   copies them to level 0 of the tree, then sums
//   levels 1 .. d of its tile in shared memory, writing each node once.
//   The levels above span tiles: each block fences its writes and takes a
//   ticket (an atomic counter that wraps to 0 for the next launch), and the
//   block that takes the last ticket sums them, reading the level below
//   through L2 (__ldcg), after a fence.  At 1e6 leaves: 245 blocks write
//   levels 0-2 (1e6, 15 625, 245 nodes), the last one level 3 (4 nodes).
//   Bound: bytes, the leaves read once and the tree written once: 4n + 4
//   x (tree size) = 8.06 MB, 2.41 us, at n = 1e6; 0.53 MB, 0.16 us, at the
//   65 536 buckets of ogb_tree.  Two launches must not run at once on one
//   device (the ticket is one counter); the port launches on one stream.
// * repro_tree_build_i32: the same kernel over int32 leaves (the tree LRU's
//   mark counts, rebuilt at each ring compaction: radix 16, 4096-leaf tiles,
//   levels 1-3 in shared memory).  Integer sums are exact in any order.
//   Bound: 4n + 4 x (tree size) bytes: 2.22 MB, 0.66 us, at 262 144 leaves.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileLeaves = 4096;  // leaves a block of the tree build owns at most
constexpr int kBuildThreads = 512;
constexpr int kBuildWarps = kBuildThreads / 32;
constexpr int kQuads = kTileLeaves / 4 / kBuildThreads;  // 16-byte loads a thread
constexpr int kMaxLevels = 64;

// Sum of children base .. base + radix - 1 of a level of `size` nodes, read
// through `child`; the sum lands in lane 0.  Every lane of the warp calls it.
template <typename T, typename Child>
__device__ __forceinline__ T node_sum(Child child, long long base, int radix, long long size,
                                      int lane) {
  T s = T(0);
  for (int j = lane; j < radix; j += 32) {
    const long long i = base + j;
    s += i < size ? child(i) : T(0);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  return s;
}

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ values, long long n, int radix,
              float* __restrict__ out, long long out_size) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  auto child = [values](long long i) { return values[i]; };
  for (long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); g < out_size;
       g += stride) {
    const float s = node_sum<float>(child, g * radix, radix, n, lane);
    if (lane == 0) out[g] = s;
  }
}

// Level sizes and offsets of the flat tree; levels [1, in_block] are summed
// inside a block's tile of `span` leaves, the rest by the last block.
struct Levels {
  long long size[kMaxLevels];
  long long off[kMaxLevels];
  int count;
  int in_block;
  int span;
};

__device__ unsigned int build_ticket = 0;

// Four values of type T in one 16-byte word.
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using type = float4;
};
template <>
struct Quad<int> {
  using type = int4;
};

// Leaves g .. g + 3, zero past n: one 16-byte load where the leaves allow it.
template <typename T>
__device__ __forceinline__ typename Quad<T>::type load4(const T* __restrict__ p, long long g,
                                                        long long n, bool aligned) {
  using Q = typename Quad<T>::type;
  if (aligned && g + 3 < n) return __ldg(reinterpret_cast<const Q*>(p + g));
  Q v;
  v.x = g < n ? __ldg(p + g) : T(0);
  v.y = g + 1 < n ? __ldg(p + g + 1) : T(0);
  v.z = g + 2 < n ? __ldg(p + g + 2) : T(0);
  v.w = g + 3 < n ? __ldg(p + g + 3) : T(0);
  return v;
}

// Stores v to p[g .. g + 3] short of n (p 16-byte aligned, g a multiple of 4).
template <typename T, typename Q>
__device__ __forceinline__ void store4(T* __restrict__ p, long long g, long long n, Q v) {
  if (g + 3 < n) {
    *reinterpret_cast<Q*>(p + g) = v;
    return;
  }
  if (g < n) p[g] = v.x;
  if (g + 1 < n) p[g + 1] = v.y;
  if (g + 2 < n) p[g + 2] = v.z;
}

template <typename T>
__global__ void __launch_bounds__(kBuildThreads)
tree_build_kernel(const T* __restrict__ leaves, T* __restrict__ tree, int radix, Levels lv) {
  using Q = typename Quad<T>::type;
  __shared__ __align__(16) T tile[kTileLeaves];
  __shared__ T sums[2][kTileLeaves / 2];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = lv.size[0];
  const long long t0 = (long long)blockIdx.x * lv.span;

  // the tile's leaves, read once: into shared memory and level 0 of the tree
  // (span is a power of two of at least 4)
  const bool aligned = (reinterpret_cast<std::uintptr_t>(leaves) & 15) == 0;
  const int quads = (lv.span + 3) / 4;
  Q v[kQuads];
#pragma unroll
  for (int u = 0; u < kQuads; ++u) {
    const int i = threadIdx.x + u * kBuildThreads;
    if (i < quads) v[u] = load4(leaves, t0 + 4LL * i, min(n, t0 + lv.span), aligned);
  }
#pragma unroll
  for (int u = 0; u < kQuads; ++u) {
    const int i = threadIdx.x + u * kBuildThreads;
    if (i < quads) {
      reinterpret_cast<Q*>(tile)[i] = v[u];
      store4(tree, t0 + 4LL * i, min(n, t0 + lv.span), v[u]);
    }
  }
  __syncthreads();

  // levels 1 .. in_block of the tile; a node past its level's size sums
  // zeros and is not written
  const T* below = tile;
  int nodes = lv.span;
  long long first = t0;
  for (int l = 1; l <= lv.in_block; ++l) {
    nodes /= radix;
    first /= radix;
    T* out = sums[(l - 1) & 1];
    auto child = [below](long long i) { return below[i]; };
    for (int g = warp; g < nodes; g += kBuildWarps) {
      const T s = node_sum<T>(child, (long long)g * radix, radix, (long long)nodes * radix, lane);
      if (lane == 0) {
        out[g] = s;
        if (first + g < lv.size[l]) tree[lv.off[l] + first + g] = s;
      }
    }
    __syncthreads();
    below = out;
  }
  if (lv.count - 1 <= lv.in_block) return;  // the tiles held the whole tree

  // the levels above: summed by the block that finishes last
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(&build_ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int l = lv.in_block + 1; l < lv.count; ++l) {
    const T* level = tree + lv.off[l - 1];
    auto child = [level](long long i) { return __ldcg(level + i); };
    for (long long g = warp; g < lv.size[l]; g += kBuildWarps) {
      const T s = node_sum<T>(child, g * radix, radix, lv.size[l - 1], lane);
      if (lane == 0) tree[lv.off[l] + g] = s;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int repro_segsum(const void* values, long long n, int radix, void* out,
                            long long out_size, void* stream) {
  if (out_size > 0) {
    long long blocks = (out_size + kWarps - 1) / kWarps;
    if (blocks > 65535) blocks = 65535;
    segsum_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values), n, radix, static_cast<float*>(out), out_size);
  }
  return (int)cudaGetLastError();
}

namespace {

// The whole tree over sizes[0] >= 1 leaves of type T into `tree` (the sum of
// the `count` level sizes, 16-byte aligned), `radix` a power of two in
// [2, kTileLeaves].
template <typename T>
int build_tree(const void* leaves, void* tree, const long long* sizes, int count, int radix,
               void* stream) {
  if (count < 1 || count > kMaxLevels || radix < 2 || radix > kTileLeaves || sizes[0] < 1 ||
      (reinterpret_cast<std::uintptr_t>(tree) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv{};
  long long off = 0;
  for (int l = 0; l < count; ++l) {
    lv.size[l] = sizes[l];
    lv.off[l] = off;
    off += sizes[l];
  }
  lv.count = count;
  int depth = 1, span = radix;
  while ((long long)span * radix <= kTileLeaves) {
    span *= radix;
    ++depth;
  }
  lv.span = span;
  lv.in_block = depth < count - 1 ? depth : count - 1;
  const long long blocks = (sizes[0] + span - 1) / span;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tree_build_kernel<T><<<(unsigned)blocks, kBuildThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(leaves), static_cast<T*>(tree), radix, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// A float32 tree (tree_build over float32 leaves).
extern "C" int repro_tree_build(const void* leaves, void* tree, const long long* sizes, int count,
                                int radix, void* stream) {
  return build_tree<float>(leaves, tree, sizes, count, radix, stream);
}

// An int32 tree (tree_build over int32 leaves: the tree LRU's mark counts).
extern "C" int repro_tree_build_i32(const void* leaves, void* tree, const long long* sizes,
                                    int count, int radix, void* stream) {
  return build_tree<int>(leaves, tree, sizes, count, radix, stream);
}
