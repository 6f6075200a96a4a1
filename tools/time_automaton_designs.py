#!/usr/bin/env python3
"""The automata's kernels against the designs they replaced, on one card.

    python3 tools/time_automaton_designs.py

Run from the root of a checkout on one NVIDIA card.  The earlier designs of
``minpair_automaton`` (the tree LFU, FTPL and GDS: a descent from the root
by warp-wide reductions at every miss, and every hit's leaf group reloaded
from L2) and of ``tree_lru`` (every level of the ring's tree in L2, read a
child at a time), kept here as text and not in the package (the package's
``csrc/minpair_automaton.cu`` and ``csrc/tree_lru.cu`` before their
redesign), and of ``fifo_queue`` (one warp, a chain of 32 request steps a
tile, an item -> slot map kept current by broadcast: the package's
``csrc/fifo_queue.cu`` before its tile plan and admission tickets), are
compiled with nvcc into ``build/`` and timed beside the package's kernels
at chip_smoke.py's timed shapes (``TREE_TIMED``): a chunk from a full carry
at quick's shape (C = 1000, N = 20 000, 10 000 requests) and at fig8_cdn
full's (C = 50 000, N = 1e6, 1e6 requests), for LRU, LFU, FTPL, GDS
(dyadic sizes by popularity quartile, unit costs) and FIFO.

Cold (L2 flushed before each call), in the order earlier, current,
current, earlier; both designs are held to the plain version exactly (the
hits, the stats and every carry leaf).  It prints the card and its power
limit first, a line a case, and a JSON line of every time last.
chip_smoke.py's phases 19 (LRU, LFU, FTPL) and 20 (GDS, FIFO) time the
kernels through :func:`time_designs`.
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

#: timed calls a round at each shape (a round: one design, cold)
REPS = {1000: 3, 50000: 1}
#: what the earlier designs did
EARLIER_DESIGNS = {
    "minpair_automaton": "one warp a chunk, the requests in order: a miss descends from the "
                         "root by warp-wide reductions over 64 children a level, a hit reloads "
                         "its leaf group from L2 and reduces it; GDS's L reloaded from L2",
    "tree_lru": "one block a chunk, a thread a request of a 256-request sub-chunk: previous "
                "request by a scan of the sub-chunk's 256 ids; every level of the ring's tree "
                "in L2, a prefix read a child at a time (up to 16 scalar loads a level)",
    "fifo_queue": "one warp a chunk: a tile of 32 requests and their 32 possible victims read "
                  "at once, then a chain of 32 request steps (a broadcast shuffle a request; a "
                  "miss three more and lane 0's four stores), an item -> slot map kept current "
                  "by broadcast",
}
#: ``csrc/fifo_queue.cu`` before its tile plan and admission tickets
EARLIER_FIFO = r"""// FIFO at any capacity: one chunk of requests, in order, in one launch.
//
// The reference has no Pallas kernel here: it scans FIFO's per-request step
// over the chunk with lax.scan (src/repro/cachesim/engines.py: _fifo_step),
// each step a compare over every slot and an argmin over their stamps.  The
// port's plain version is ../ref.py's fifo_queue_ref; this kernel computes
// the same, bit for bit: the hits, the flags, and the carry (slots, stamps,
// the clock t) with the run's derived state (head, imap, occupancy).
//
// FIFO never refreshes a stamp and a miss writes the clock, above every
// stamp, into the slot of the least (stamp, index): so the victims walk the
// active slots in one fixed order (`order`, derived once a run), and a miss
// takes order[head] and advances head.  A request is then O(1): one imap
// read to find a hit, and on a miss the victim's slot and the item it held.
//
// One warp walks the requests in tiles of 32.  At the start of a tile each
// lane loads one request's id and imap entry, and the victim a miss would
// take were it the lane-th miss of the tile (order[head + lane] and the item
// its slot holds), so the tile's reads are in flight together.  Then per
// request, every lane in step: the request's imap entry is broadcast from
// its lane; a hit changes nothing; the k-th miss of the tile takes lane k's
// victim, and lane 0 writes slots, stamps and imap.  Each write is broadcast
// so that the lanes keep their entries current: a lane whose id was evicted
// reads -1, a lane whose id was admitted the slot, and a later victim that
// is the same slot (fewer than 32 active slots) the item just written.
//
// Bound on an H100: the bytes (the ids, the requested imap entries, and each
// miss's order, slot and stamp entries and two imap writes) take well under
// a microsecond at a 10 000-request chunk; the kernel is latency-bound: per
// tile two trips to L2 (ids then imap; order then slots), then a chain of
// warp shuffles a request.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32)
    fifo_queue_kernel(int* __restrict__ slots, int* __restrict__ stamps, int* __restrict__ tclock,
                      const int* __restrict__ order, int active, int* __restrict__ head_p,
                      int* __restrict__ imap, int* __restrict__ occ_p,
                      const int* __restrict__ ids, int window, unsigned char* __restrict__ flags,
                      int* __restrict__ hits_out, float* __restrict__ stats) {
  const int lane = threadIdx.x;
  const int t0 = *tclock;
  int head = *head_p, occ = *occ_p, hits = 0;
  for (int base = 0; base < window; base += 32) {
    const int n = min(32, window - base);
    int j = -1, mine = -1;
    if (lane < n) {
      j = __ldg(ids + base + lane);
      mine = __ldcg(imap + j);
    }
    // the victim of the tile's lane-th miss, and the item its slot holds
    int pos = head + lane;
    pos = pos < active ? pos : pos % active;
    const int victim = __ldg(order + pos);
    int held = __ldcg(slots + victim);
    int misses = 0;
    for (int q = 0; q < n; ++q) {
      const int slot = __shfl_sync(kFull, mine, q);
      const bool hit = slot >= 0;
      if (flags != nullptr && lane == 0) flags[base + q] = hit;
      if (hit) {
        ++hits;
        continue;
      }
      const int jq = __shfl_sync(kFull, j, q);
      const int v = __shfl_sync(kFull, victim, misses);
      const int old = __shfl_sync(kFull, held, misses);
      if (lane == 0) {
        if (old >= 0) imap[old] = -1;
        imap[jq] = v;
        slots[v] = jq;
        stamps[v] = t0 + base + q;
      }
      if (old >= 0 && j == old) mine = -1;
      if (j == jq) mine = v;
      if (victim == v) held = jq;
      occ += old < 0;
      ++misses;
    }
    head += misses;
    head = head < active ? head : head % active;
    __syncwarp();  // the tile's writes are seen by the next tile's reads
  }
  if (lane == 0) {
    *head_p = head;
    *occ_p = occ;
    *tclock = t0 + window;
    *hits_out = hits;
    stats[0] = (float)hits;  // reward: an automaton's reward is its hits
    stats[1] = 0.0f;         // aux: no threshold
    stats[2] = (float)occ;
  }
}

}  // namespace

// slots and stamps: the carry's (K,) int32; tclock its () int32 clock.
// order: the `active` slots by (stamp, index); head, occ: () int32; imap:
// one int32 an item (-1 where not held), covering every id.  flags: null,
// or one byte a request.  hits: one int32; stats: three float32.
extern "C" int repro_fifo_queue(int window, const void* ids, void* slots, void* stamps,
                                void* tclock, const void* order, int active, void* head,
                                void* imap, void* occ, void* flags, void* hits, void* stats,
                                void* stream) {
  if (window < 1 || active < 1) return (int)cudaErrorInvalidValue;
  fifo_queue_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(slots), static_cast<int*>(stamps), static_cast<int*>(tclock),
      static_cast<const int*>(order), active, static_cast<int*>(head), static_cast<int*>(imap),
      static_cast<int*>(occ), static_cast<const int*>(ids), window,
      static_cast<unsigned char*>(flags), static_cast<int*>(hits), static_cast<float*>(stats));
  return (int)cudaGetLastError();
}
"""
#: ``csrc/minpair_automaton.cu`` before its redesign
EARLIER_MINPAIR = r"""// The tree LFU, FTPL and GDS: one chunk of requests, in order, in one launch.
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
// inactive slots (INT32_MAX, INT32_MAX).  A
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
//     hi is strictly above the root's; GDS always writes: a hit refreshes its
//     H from the current L, a miss evicts the argmin (L takes its H if it
//     held an item) and keys the newcomer;
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

constexpr int kLFU = 0, kFTPL = 1, kGDS = 2;
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
                         int* __restrict__ tclock, float* __restrict__ hval,
                         float* __restrict__ lval, const int* __restrict__ ids, int window,
                         int n_items, const Levels& lv, unsigned char* __restrict__ flags,
                         int* __restrict__ hits_out) {
  const int lane = threadIdx.x;
  const int top = lv.count - 1;
  const int k_slots = lv.size[0];
  const long long up = lv.count > 1 ? lv.off[1] : 0;  // shared node x is tree node up + x
  const int t0 = KIND == kLFU ? *tclock : 0;
  float L = KIND == kGDS ? *lval : 0.0f;  // GDS: the inflation value, warp-uniform
  int hits = 0, scratch = -1;

  for (int base = 0; base < window; base += 32) {
    const int n = min(32, window - base);
    int j = -1, mine = -1, f = 0, key = 0;
    float prio = 0.0f;  // GDS: the request's cost / size (`noise` holds them)
    if (lane < n) {
      j = __ldg(ids + base + lane);
      mine = __ldcg(imap + j);
      if (KIND == kGDS) {
        prio = __ldg(noise + j);
      } else {
        f = __ldcg(counts + j);
      }
    }
    int rank = 0;
    bool final = true;
    if (KIND != kGDS) {  // GDS keeps no counts
      for (int s = 0; s < n; ++s) {
        const int js = __shfl_sync(kFull, j, s);
        if (js == j) {
          rank += s < lane;
          final &= s <= lane;
        }
      }
    }
    f += rank + 1;
    if (KIND == kFTPL && lane < n) key = sortable(__fadd_rn(__int2float_rn(f), __ldg(noise + j)));

    for (int q = 0; q < n; ++q) {
      const int jq = __shfl_sync(kFull, j, q);
      const int fq = __shfl_sync(kFull, f, q);
      const int slot = __shfl_sync(kFull, mine, q);
      int nh = KIND == kLFU ? fq : __shfl_sync(kFull, key, q);
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
        write = KIND == kGDS || (KIND == kLFU ? nh >= root.h : nh > root.h);
        if (KIND == kGDS) {
          // evict first: L takes the H of a real victim, then the newcomer
          // is keyed off it; an empty slot's fill leaves L as it is
          const int old = slot_of(leaves, idx);
          if (old >= 0) L = __ldcg(hval + idx);
          if (lane == 0) {
            if (old >= 0) imap[old] = -1;
            imap[jq] = idx;
            slots[idx] = jq;
          }
          if (old >= 0 && j == old) mine = -1;
          if (j == jq) mine = idx;
        } else if (write) {
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
        scratch = KIND == kFTPL ? idx : -1;
        leaves = load_group<true>(th, tl, slots, idx & ~(kRadix - 1), k_slots, lane);
      }
      if (KIND == kGDS) {  // a hit or a miss: H = L + cost/size of the request
        const float h = __fadd_rn(L, __shfl_sync(kFull, prio, q));
        nh = sortable(h);
        if (lane == 0) hval[idx] = h;
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

template <int KIND>
__global__ void __launch_bounds__(kThreads)
    minpair_kernel(int* __restrict__ imap, int* __restrict__ counts,
                   const float* __restrict__ noise, int* __restrict__ slots, int* __restrict__ th,
                   int* __restrict__ tl, int* __restrict__ tclock, float* __restrict__ hval,
                   float* __restrict__ lval, const int* __restrict__ ids, int window, int n_items,
                   Levels lv, unsigned char* __restrict__ flags, int* __restrict__ hits_out,
                   float* __restrict__ stats) {
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
    run_warp<KIND>(imap, counts, noise, slots, th, tl, s_hi, s_lo, tclock, hval, lval, ids,
                   window, n_items, lv, flags, hits_out);
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
           const float* noise, int* slots, int* th, int* tl, int* t, float* hval, float* lval,
           unsigned char* flags, int* hits, float* stats, cudaStream_t stream) {
  const long long up = lv.count > 1 ? lv.off[1] : 0;
  const long long upper = lv.count > 1 ? lv.off[lv.count - 1] + lv.size[lv.count - 1] - up : 0;
  const size_t smem = (size_t)(2 * upper) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        minpair_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  minpair_kernel<KIND><<<1, kThreads, smem, stream>>>(imap, counts, noise, slots, th, tl, t, hval,
                                                      lval, ids, window, n_items, lv, flags, hits,
                                                      stats);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 lfu (t its int32 clock, noise null), 1 ftpl (noise (N,) float32,
// t null), 2 gds (noise the (N,) float32 cost / size, counts and t null, hval
// the (K,) float32 slot priorities, lval the () float32 inflation value).
// sizes: the min-tree's `count` level sizes, leaves first (the slot count).
// imap holds N + 1 entries, counts N.  flags: null, or one byte a request.
// hits: one int32; stats: three float32 (reward, aux, occupancy).
extern "C" int repro_minpair_automaton(int kind, int window, const void* ids, int n_items,
                                       int count, const long long* sizes, void* imap,
                                       void* counts, const void* noise, void* slots, void* th,
                                       void* tl, void* t, void* hval, void* lval, void* flags,
                                       void* hits, void* stats, void* stream) {
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
  float* hv = static_cast<float*>(hval);
  float* lv_ = static_cast<float*>(lval);
  unsigned char* fl = static_cast<unsigned char*>(flags);
  int* ho = static_cast<int*>(hits);
  float* st = static_cast<float*>(stats);
  switch (kind) {
    case kLFU:
      return launch<kLFU>(window, id, n_items, lv, im, c, nz, sl, h, l, tc, hv, lv_, fl, ho, st, s);
    case kFTPL:
      return launch<kFTPL>(window, id, n_items, lv, im, c, nz, sl, h, l, tc, hv, lv_, fl, ho, st,
                           s);
    case kGDS:
      return launch<kGDS>(window, id, n_items, lv, im, c, nz, sl, h, l, tc, hv, lv_, fl, ho, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
"""
#: ``csrc/tree_lru.cu`` before its redesign
EARLIER_TREE_LRU = r"""// The tree LRU: one chunk of requests, by reuse distance, in one launch.
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
"""


@functools.lru_cache(maxsize=None)
def earlier_libraries():
    """Build the three earlier sources with the package's nvcc flags (in
    parallel); returns their entry points ``(minpair, tree_lru_chunk,
    fifo_queue)``."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "earlier"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, text in (("minpair_automaton_earlier", EARLIER_MINPAIR),
                       ("tree_lru_earlier", EARLIER_TREE_LRU),
                       ("fifo_queue_earlier", EARLIER_FIFO)):
        src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        src.write_text(text)
        procs.append((subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                        str(src)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), lib))
    libs = []
    for proc, lib in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log}")
        libs.append(ctypes.CDLL(str(lib)))
    i, p = ctypes.c_int, ctypes.c_void_p
    minpair = libs[0].repro_minpair_automaton
    minpair.argtypes = [i, i, p, i, i, p, p, p, p, p, p, p, p, p, p, p, p, p, p]
    minpair.restype = ctypes.c_int
    chunk = libs[1].repro_tree_lru_chunk
    chunk.argtypes = [p, p, p, p, p, p, i, p, i, p, p, p, p, p]
    chunk.restype = ctypes.c_int
    fifo = libs[2].repro_fifo_queue
    fifo.argtypes = [i, p, p, p, p, p, i, p, p, p, p, p, p, p]
    fifo.restype = ctypes.c_int
    return minpair, chunk, fifo


def earlier_fifo_queue(carry, id_bound):
    """The earlier FIFO design's queue of a carry: the order, its head (0),
    an item -> slot map (-1 where not held) and the occupancy."""
    import torch

    slots, stamps = carry.slots, carry.stamps
    active = torch.nonzero(slots != -2).reshape(-1)
    by_stamp = torch.argsort(stamps.index_select(0, active).to(torch.int64), stable=True)
    order = active.index_select(0, by_stamp).to(torch.int32)
    held = torch.nonzero(slots >= 0).reshape(-1)
    imap = torch.full((id_bound,), -1, dtype=torch.int32, device=slots.device)
    imap.index_put_((slots.index_select(0, held).to(torch.int64),), held.to(torch.int32))
    zero = torch.zeros((), dtype=torch.int32, device=slots.device)
    return [order, zero, imap, zero + held.numel()]


def earlier_fifo_chunk(carry, queue, ids):
    """One FIFO chunk through the earlier design: the carry's slots, stamps
    and clock and ``queue`` (:func:`earlier_fifo_queue`) in place."""
    import torch

    from repro_torch.kernels import _build

    fifo = earlier_libraries()[2]
    dev = ids.device
    hits = torch.empty((), dtype=torch.int32, device=dev)
    stats = torch.empty(3, dtype=torch.float32, device=dev)
    order, head, imap, occ = queue
    _build.check(fifo(ids.numel(), ids.data_ptr(), carry.slots.data_ptr(),
                      carry.stamps.data_ptr(), carry.t.data_ptr(), order.data_ptr(),
                      order.numel(), head.data_ptr(), imap.data_ptr(), occ.data_ptr(), None,
                      hits.data_ptr(), stats.data_ptr(), _build.stream_of(ids)),
                 "earlier fifo chunk")
    return hits, stats


def earlier_chunk(kind, carry, ids):
    """One chunk of ``kind`` through its earlier design, the carry in place
    (nothing counted; the LRU must not need a compaction).  Returns
    ``(hits, stats)``."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.minpair_automaton.ops import _levels
    from repro_torch.kernels.prefix_tree.ops import leaves_for_storage
    from repro_torch.kernels.tree_lru.ops import _ring

    minpair, chunk, _ = earlier_libraries()
    dev = ids.device
    hits = torch.empty((), dtype=torch.int32, device=dev)
    stats = torch.empty(3, dtype=torch.float32, device=dev)

    def ptr(x):
        return x.data_ptr() if x is not None else None

    stream = _build.stream_of(ids)
    if kind == "lru":
        m = leaves_for_storage(carry.tree.numel(), 16)
        count, sizes = _ring(m)
        code = chunk(ptr(carry.tree), ptr(carry.last), ptr(carry.pos), ptr(carry.nseen),
                     ptr(carry.cap), ptr(ids), ids.numel(), ctypes.addressof(sizes), count, None,
                     None, ptr(hits), ptr(stats), stream)
    else:
        count, sizes = _levels(carry.slots.numel())
        gds, lfu = kind == "gds", kind == "lfu"
        code = minpair(
            ("lfu", "ftpl", "gds").index(kind), ids.numel(), ptr(ids),
            (carry.prio if gds else carry.counts).numel(), count, ctypes.addressof(sizes),
            ptr(carry.imap), None if gds else ptr(carry.counts),
            ptr(carry.prio if gds else None if lfu else carry.noise), ptr(carry.slots),
            ptr(carry.tree_hi), ptr(carry.tree_lo), ptr(carry.t) if lfu else None,
            ptr(carry.hval) if gds else None, ptr(carry.L) if gds else None, None, ptr(hits),
            ptr(stats), stream)
    _build.check(code, f"earlier {kind} chunk")
    return hits, stats


def timed_start(torch, kind, c, n, w, dev):
    """A full carry at a timed shape (phase 19's fill: C distinct ids, then
    zipf), and the timed chunk."""
    import numpy as np

    from repro_torch.cachesim import tree_engines as tt
    from repro_torch.cachesim.traces import adversarial, zipf

    fill = np.concatenate([adversarial(n, c, seed=9), zipf(n, w, alpha=0.9, seed=9)])
    chunk = torch.from_numpy(zipf(n, w, alpha=0.9, seed=10).astype("int32")).to(dev)
    fill = torch.from_numpy(fill.astype("int32")).to(dev)
    if kind == "fifo":
        from repro_torch.cachesim import engines as teng

        card = teng.start_fifo_run(teng.init_engine_carry("fifo", n, c, device=dev), n)
        teng.fifo_chunk(card, fill)
        return card, chunk
    if kind == "gds":
        sizes = np.asarray([1.0, 4.0, 16.0, 64.0])[np.minimum(np.arange(n) * 4 // n, 3)]
        card = tt.init_tree_gds_carry(n, c, sizes=sizes, device=dev)
    else:
        ring = {"ring": tt.ring_for_window(c, w)} if kind == "lru" else {}
        card = tt.init_tree_engine_carry(kind, n, c, horizon=len(fill) + w, device=dev, **ring)
        card = tt.start_tree_run(card)
    card, _ = tt.tree_chunk(kind, card, fill)
    if kind != "gds":
        card = tt.start_tree_run(card)
    return card, chunk


def _plain(kind, carry, ids):
    from repro_torch.kernels.fifo_queue.ref import fifo_queue_ref
    from repro_torch.kernels.minpair_automaton.ref import gds_automaton_ref

    if kind == "fifo":
        return fifo_queue_ref(carry.slots, carry.stamps, carry.t, carry.queue, ids)
    if kind == "gds":
        return gds_automaton_ref(carry.imap, carry.prio, carry.hval, carry.L, carry.slots,
                                 carry.tree_hi, carry.tree_lo, ids)
    return smoke.tree_plain(kind, carry, ids)


def time_designs(torch, dev, kinds, flush):
    """Each kind at each of chip_smoke.py's TREE_TIMED shapes: the plain
    version's result and time, both designs held to it exactly (FIFO's
    earlier design on its own queue: the hits, stats and the carry), then
    both timed cold in the order earlier, current, current, earlier.
    Returns ``{(kind, c): row}``."""
    from repro_torch.cachesim import engines as teng
    from repro_torch.cachesim import tree_engines as tt
    from repro_torch.kernels.prefix_tree.ops import leaves_for_storage
    from repro_torch.kernels.tree_lru.ops import tree_lru

    rows = {}
    for c, (n, w) in smoke.TREE_TIMED.items():
        for kind in kinds:
            fifo = kind == "fifo"
            tensors = smoke.fifo_tensors if fifo else smoke.tree_tensors
            card, chunk = timed_start(torch, kind, c, n, w, dev)
            if fifo:
                start, plain = smoke.fifo_copy(card, dev), smoke.fifo_copy(card, dev)
                old_queue = earlier_fifo_queue(card, n)
                old_start = [x.clone() for x in old_queue]
            else:
                start = type(card)(*(x.clone() for x in tensors(card)))
                plain = type(card)(*(x.clone() for x in tensors(card)))
            t0 = time.perf_counter()
            want = _plain(kind, plain, chunk)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            if kind == "lru":
                m = leaves_for_storage(card.tree.numel(), 16)
                smoke.need(int(card.pos) + w <= m, "the timed LRU chunk would compact")

                def current(card=card, m=m):
                    return tree_lru(card.tree, card.last, card.pos, card.nseen, card.cap, chunk,
                                    m, compact=False)
            elif fifo:
                def current(card=card):
                    return teng.fifo_chunk(card, chunk)[1]
            else:
                def current(card=card, kind=kind):
                    return tt.tree_chunk(kind, card, chunk)[1]

            if fifo:
                def earlier(card=card, old_queue=old_queue):
                    return earlier_fifo_chunk(card, old_queue, chunk)
            else:
                def earlier(card=card, kind=kind):
                    return earlier_chunk(kind, card, chunk)

            def reset(card=card, tensors=tensors, start=start):
                for x, x0 in zip(tensors(card), tensors(start)):
                    x.copy_(x0)
                if fifo:
                    for x, x0 in zip(old_queue, old_start):
                        x.copy_(x0)

            label = f"{kind} C={c} N={n}, a {w}-request chunk from a full carry"
            err = 0.0
            for name, fn in (("earlier", earlier), ("current", current)):
                reset()
                got = fn()
                if fifo and name == "earlier":  # its queue is its own
                    mine, theirs = card[:3], plain[:3]
                else:
                    mine, theirs = tensors(card), tensors(plain)
                e = smoke.max_abs_diff(torch, (*got, *mine), (*want, *theirs))
                smoke.need(e == 0, f"{label}: the {name} design differs from the plain version "
                                   f"by {e}")
                err = max(err, e)
            hits = int(want[0])
            if kind in ("lru", "fifo"):
                evicted = w - hits  # the cache is full: every miss evicts
            else:
                evicted = len(set(start.slots.tolist()) - set(plain.slots.tolist()))
            smoke.need(evicted > 0, f"{label}: no eviction")
            if fifo:
                n_bytes = smoke.fifo_bytes(torch, chunk, hits)
            elif kind == "gds":
                n_bytes = smoke.gds_bytes(torch, start, plain, chunk)
            else:
                n_bytes = smoke.tree_bytes(torch, kind, start, plain, chunk)
            bound, by = smoke.bound_ms(n_bytes, 0)
            runs = {"earlier": [], "current": []}
            for name in ("earlier", "current", "current", "earlier"):
                fn = earlier if name == "earlier" else current
                runs[name].append(smoke.timed_ms(torch, fn, REPS[c], flush, reset=reset))
            reset()
            ms = {k: sum(v) / len(v) for k, v in runs.items()}
            rows[kind, c] = {
                "ms": ms["current"], "earlier_ms": ms["earlier"], "runs_ms": runs,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "max_abs_err": err,
                "us_per_request": ms["current"] * 1e3 / w,
                "earlier_us_per_request": ms["earlier"] * 1e3 / w,
                "plain_us_per_request": plain_ms * 1e3 / w, "window": w, "N": n, "C": c,
                "hits": hits, "evicted": evicted, "bytes": n_bytes}
            print(f"{label} ({hits} hits, {evicted} evicted): current "
                  f"{ms['current']:.4f} ms ({ms['current'] * 1e3 / w:.5f} us a request), "
                  f"earlier design {ms['earlier']:.4f} ms ({ms['earlier'] * 1e3 / w:.5f}); "
                  f"plain on the card {plain_ms:.2f} ms; bound {bound * 1e3:.4f} us by {by} "
                  f"({n_bytes} bytes); both exact")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this timing needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    print(f"card: {smoke.nvidia_smi_line()}")
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.build_all()
    earlier_libraries()
    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)  # 256 MB > L2

    def flush():
        flush_buf.zero_()

    rows = time_designs(torch, dev, ("lru", "lfu", "ftpl", "gds", "fifo"), flush)
    print(json.dumps({"automaton_designs": [
        {k: v for k, v in row.items() if k != "runs_ms"} | {"kind": kind, "runs_ms": row["runs_ms"]}
        for (kind, _), row in rows.items()]}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except smoke.Failed as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
