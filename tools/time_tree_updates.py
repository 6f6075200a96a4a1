#!/usr/bin/env python3
"""The batched tree update beside its earlier plan, on one NVIDIA card.

    python3 tools/time_tree_updates.py

Run from the root of a checkout.  ``csrc/tree_update.cu`` (the port's
``tree_update_`` and ``stacked_tree_update_`` on a CUDA tensor) sorts a
call's deltas into runs by node in shared memory and sums each run alone.
Its earlier plan (each node's first delta by ``atomicMin``
into an int32 scratch the size of the tree, then a warp a node walking
every later delta of the call) is kept here as text (``EARLIER``) and built
into ``build/repro_torch/earlier/``.  At each case both are held bit for
bit to the plain version on the card and on the CPU, then timed cold (L2
flushed) in the order earlier, current, current, earlier, and warm in L2,
beside the plain version, one PyTorch call that computes the same sums
(``index_put_(accumulate=True)`` of the float64 (node, delta) pairs alone;
``index_add_`` for an int32 tree) and the bound.  Each case prints its
order of the adds, its distinct nodes a level, its longest run under one
node and the nodes it changed.

Cases (:func:`sized_cases`, :func:`ogb_tree_cases`): the three stacked
updates of a sized_cdn full chunk recorded from a mid-run state
(chip_smoke.py's ``sized_state``), 2000 int32 deltas scattered over a
262 144-leaf ring tree, a stacked call at the sized shape whose deltas
span many decades (input order), and ``ogb_tree``'s recorded one-tree chunk
(chip_smoke.py's ``record_chunk_updates``), a run of 2000 deltas under one
node and the same in input order.  chip_smoke.py phases 3 and 20 call
:func:`time_updates`.  It prints the card and its power limit first and a
JSON line of every case last.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402

REPS = 20
#: a C = 50 000 ring's int32 tree (chip_smoke.py's INT32_BUILD_LEAVES[0]) at
#: the ring's radix, and the deltas of a call
INT32_LEAVES, INT32_RADIX, DELTAS = 262_144, 16, 2000
#: what the earlier plan did
EARLIER_DESIGN = ("a block a level: each node's first delta by atomicMin into an int32 scratch "
                  "the size of the tree, then a warp a node walks every later delta of the call "
                  "(any order where exact, else input order): O(nodes x deltas) a level")
#: ``csrc/tree_update.cu`` before its hashed runs
EARLIER = r"""
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
"""


@functools.lru_cache(maxsize=None)
def earlier_entry():
    """The earlier plan, built with the package's nvcc flags: its C entry
    point (the current one's arguments, with the int32 scratch in place of
    the workspace)."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "earlier"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "tree_update_earlier.cu", out_dir / "libtree_update_earlier.so"
    src.write_text(EARLIER)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {lib.name}:\n{proc.stdout}")
    fn = ctypes.CDLL(str(lib)).repro_tree_update
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, p, i, i, p, p, i, i, ll, p, ll, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def earlier_scratch(device, nodes):
    """The earlier plan's scratch: an int32 a node, INT_MAX between calls."""
    import torch

    return torch.full((nodes,), 2**31 - 1, dtype=torch.int32, device=device)


def earlier_update(tree, n, radix, rows, idx, delta):
    """One launch of the earlier plan, in place, as the wrapper launched it."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.prefix_tree.ops import _levels, radix_shift

    count, sizes = _levels(n, radix)
    n_rows, stride = (tree.shape[0], tree.shape[1]) if rows is not None else (1, tree.numel())
    _build.check(earlier_entry()(
        tree.data_ptr(), int(tree.dtype == torch.int32),
        ctypes.addressof(sizes), count, radix_shift(radix), idx.data_ptr(),
        rows.data_ptr() if rows is not None else None, idx.element_size(), n_rows, stride,
        delta.data_ptr(), idx.numel(), earlier_scratch(tree.device, tree.numel()).data_ptr(),
        _build.stream_of(tree)), "earlier tree_update")
    return tree


def current_update(tree, n, radix, rows, idx, delta):
    from repro_torch.kernels.prefix_tree.ops import stacked_tree_update_, tree_update_

    if rows is None:
        return tree_update_(tree, n, radix, idx, delta)
    return stacked_tree_update_(tree, n, radix, rows, idx, delta)


def plain_update(tree, n, radix, rows, idx, delta):
    from repro_torch.kernels.prefix_tree.ref import stacked_tree_update_ref, tree_update_ref

    if rows is None:
        return tree_update_ref(tree, n, radix, idx, delta)
    return stacked_tree_update_ref(tree, n, radix, rows, idx, delta)


def pairs(torch, tree, n, radix, rows, idx, delta):
    """The flat (node, delta) pairs of a call, the deltas that add nothing
    at node 0 with 0: what the plain version accumulates."""
    from repro_torch.kernels.prefix_tree.ops import tree_offsets

    n_rows = tree.shape[0] if rows is not None else 1
    ok = (idx >= 0) & (idx < n)
    base = torch.zeros_like(idx, dtype=torch.int64)
    if rows is not None:
        ok &= (rows >= 0) & (rows < n_rows)
        base = torch.where(ok, rows, torch.zeros_like(rows)).long() * tree.shape[1]
    node, nodes = torch.where(ok, idx, torch.zeros_like(idx)).long(), []
    for off in tree_offsets(n, radix):
        nodes.append(base + off + node)
        node = node // radix
    vals = torch.where(ok, delta, torch.zeros_like(delta)).repeat(len(nodes))
    return torch.cat(nodes), vals, ok


def work(torch, tree, n, radix, rows, idx, delta):
    """What a call asks of the card: the deltas that add, the distinct nodes
    a level (keyed by row), the longest run under one node, the order of
    the adds."""
    from repro_torch.kernels.prefix_tree.ops import tree_offsets, update_order

    nodes, _, ok = pairs(torch, tree, n, radix, rows, idx, delta)
    levels = len(tree_offsets(n, radix))
    keys, longest = [], 0
    for level in nodes.view(levels, -1):
        _, counts = torch.unique(level[ok], return_counts=True)
        keys.append(int(counts.numel()))
        longest = max(longest, int(counts.max()) if counts.numel() else 0)
    n_rows = tree.shape[0] if rows is not None else 1
    return {"deltas": int(idx.numel()), "adding": int(ok.sum()), "keys_by_level": keys,
            "touched_nodes": sum(keys), "longest_run": longest,
            "order": update_order(n, idx, delta, rows, n_rows)}


def time_updates(torch, dev, flush, cases):
    """Each case ``label: (tree, n, radix, rows or None, idx, delta)``: the
    current and the earlier plan against the plain version on the card and
    the CPU, bit for bit (and two current runs), one launch a call, then
    cold in turns and warm, beside the plain version, the library call and
    the bound.  Returns ``{label: row}``."""
    from repro_torch.kernels import design_counts, launch_counts

    rows_out = {}
    for label, (tree0, n, radix, rows, idx, delta) in cases.items():
        want = plain_update(tree0.clone(), n, radix, rows, idx, delta)
        on_cpu = plain_update(tree0.cpu(), n, radix, None if rows is None else rows.cpu(),
                              idx.cpu(), delta.cpu())
        smoke.need(torch.equal(want.cpu(), on_cpu), f"tree update {label}: the plain version "
                   f"on the card differs from the CPU's")
        before, designs = launch_counts()["tree_update"], dict(design_counts().get(
            "tree_update", {}))
        got = current_update(tree0.clone(), n, radix, rows, idx, delta)
        launched = launch_counts()["tree_update"] - before
        design = [d for d, k in design_counts()["tree_update"].items() if k > designs.get(d, 0)]
        smoke.need(launched == 1 and len(design) == 1,
                   f"tree update {label}: {launched} launches a call")
        again = current_update(tree0.clone(), n, radix, rows, idx, delta)
        earlier = earlier_update(tree0.clone(), n, radix, rows, idx, delta)
        for name, t in (("current", got), ("again", again), ("earlier", earlier)):
            smoke.need(torch.equal(t, want) and torch.equal(t.cpu(), on_cpu),
                       f"tree update {label}: the {name} plan differs from the plain version")
        stats = work(torch, tree0, n, radix, rows, idx, delta)
        changed = int((got != tree0).sum())
        smoke.need(changed > 0, f"tree update {label}: nothing changed, a vacuous check")
        out = tree0.clone()

        def reset(out=out, tree0=tree0):
            out.copy_(tree0)

        def call(plan, out=out, n=n, radix=radix, rows=rows, idx=idx, delta=delta):
            return lambda: plan(out, n, radix, rows, idx, delta)

        cold = {"earlier": [], "current": []}
        for name in ("earlier", "current", "current", "earlier"):
            plan = earlier_update if name == "earlier" else current_update
            cold[name].append(smoke.timed_ms(torch, call(plan), REPS, flush, reset=reset))
        warm = {name: smoke.timed_ms(torch, call(plan), REPS, None, reset=reset)
                for name, plan in (("current", current_update), ("earlier", earlier_update))}
        plain = smoke.timed_ms(torch, call(plain_update), 5, flush, reset=reset)
        nodes, vals, _ = pairs(torch, tree0, n, radix, rows, idx, delta)
        if tree0.dtype == torch.int32:
            lib_tree = tree0.clone().view(-1)
            library = smoke.timed_ms(torch, lambda: lib_tree.index_add_(0, nodes, vals), REPS,
                                     flush)
            ops_rate = smoke.FP32_OPS_PER_S
        else:
            acc = torch.zeros(tree0.numel(), dtype=torch.float64, device=dev)
            vals = vals.double()
            library = smoke.timed_ms(
                torch, lambda: acc.index_put_((nodes,), vals, accumulate=True), REPS, flush)
            ops_rate = smoke.FP64_OPS_PER_S
        n_bytes = (idx.element_size() * (1 if rows is None else 2) + 4) * idx.numel() \
            + 8 * stats["touched_nodes"]
        b, by = smoke.bound_ms(n_bytes, stats["adding"] * len(stats["keys_by_level"]), ops_rate)
        ms = {k: sum(v) / len(v) for k, v in cold.items()}
        rows_out[label] = {
            "ms": ms["current"], "warm_ms": warm["current"], "earlier_ms": ms["earlier"],
            "earlier_warm_ms": warm["earlier"], "runs_ms": cold, "plain_ms": plain,
            "library_ms": library, "bound_ms": b, "bound_by": by, "max_abs_err": 0.0,
            "design": design[0], "changed_nodes": changed, **stats}
        print(f"tree update, {label}: {stats['deltas']} deltas ({stats['adding']} adding), "
              f"{stats['order']}, nodes a level {stats['keys_by_level']}, longest run "
              f"{stats['longest_run']}, {changed} nodes changed; cold {ms['current'] * 1e3:.2f} "
              f"us (earlier plan {ms['earlier'] * 1e3:.2f}), warm {warm['current'] * 1e3:.2f} "
              f"({warm['earlier'] * 1e3:.2f}); plain {plain * 1e3:.2f} us, library "
              f"{library * 1e3:.2f} us, bound {b * 1e3:.4f} us by {by}; both plans bit for bit "
              f"on the card and the CPU, 1 launch a call ({design[0][:40]}...)")
    return rows_out


def sized_cases(torch, dev, calls):
    """The sized path's cases: ``calls``, chip_smoke.py's recorded stacked
    updates ((trees, v, radix, rows, idx, delta) for ycnt, ysum, dcnt);
    2000 int32 deltas scattered over a ring's tree; and a stacked call at
    the sized shape whose deltas span many decades (input order)."""
    from repro_torch.kernels.prefix_tree.ref import tree_build_ref

    cases = {f"sized_cdn full {name}": call for name, call in zip(("ycnt", "ysum", "dcnt"), calls)}
    gen = torch.Generator().manual_seed(24)
    m = INT32_LEAVES
    tree = tree_build_ref(torch.randint(0, 2, (m,), dtype=torch.int32, generator=gen), INT32_RADIX)
    cases["int32, scattered"] = (
        tree.to(dev), m, INT32_RADIX, None, torch.randint(-1, m, (DELTAS,), generator=gen).to(dev),
        torch.randint(-1, 2, (DELTAS,), dtype=torch.int32, generator=gen).to(dev))
    trees, v, radix, rows, idx, _ = calls[1]
    wide = torch.randn(idx.numel(), generator=gen) * 10.0 ** (
        torch.rand(idx.numel(), generator=gen) * 12 - 8)
    cases["stacked, input order"] = (trees, v, radix, rows, idx, wide.to(dev))
    return cases


def ogb_tree_cases(torch, dev, calls):
    """The one-tree path's cases: ``calls``, chip_smoke.py's recorded
    ogb_tree chunk ({ycnt, ysum, dcnt: (tree, n, radix, idx, delta)}); a run
    of 2000 deltas under one node, and the same spanning twelve decades."""
    cases = {f"ogb_tree {k}": (t, n, r, None, i, d) for k, (t, n, r, i, d) in calls.items()}
    tree, n, radix, idx, delta = calls["ysum"]
    gen = torch.Generator().manual_seed(6)
    one = torch.full_like(idx, int(idx[idx >= 0][0]))
    cases["one node"] = (tree, n, radix, None, one, delta)
    wide = torch.randn(idx.numel(), generator=gen) * 10.0 ** (
        torch.rand(idx.numel(), generator=gen) * 12 - 8)
    cases["one node, input order"] = (tree, n, radix, None, one, wide.to(dev))
    return cases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this tool needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.cachesim.traces import zipf
    from repro_torch.core.ogb import theoretical_eta
    from repro_torch.kernels import _build

    print(f"card: {smoke.nvidia_smi_line()}")
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    _, logs = _build.build_all()
    earlier_entry()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for line in logs["tree_update"].splitlines():
        if "Function properties" in line or "Used" in line or "spill" in line:
            print(f"  tree_update: {line.strip()}")
    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)  # 256 MB > L2

    def flush():
        flush_buf.zero_()

    try:
        cases = sized_cases(torch, dev, smoke.sized_state(torch)["update"])
        trace = zipf(smoke.N, smoke.T, alpha=smoke.ALPHA, seed=0)
        eta = theoretical_eta(smoke.C, smoke.N, smoke.T, 1)
        carry = smoke.tree_state(trace, eta)
        cases.update(ogb_tree_cases(torch, dev, smoke.record_chunk_updates(trace, carry)))
        out = time_updates(torch, dev, flush, cases)
    except smoke.Failed as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"card": smoke.nvidia_smi_line(), "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
