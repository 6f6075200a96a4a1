// The slot automata (LRU, FIFO, LFU, FTPL): one chunk of requests, in order,
// in one launch.
//
// The reference has no Pallas kernel here: it scans each automaton's
// per-request step over the requests with lax.scan
// (src/repro/cachesim/engines.py: _lru_step, _fifo_step, _lfu_step,
// _ftpl_step, scanned by api.py's _automaton_def, impl="dense").  The port's
// plain version is ../ref.py's slot_automaton_ref.  This kernel computes the
// same, bit for bit: the hits, and the carry slot for slot.
//
// One block; the K slots are spread over its threads, slot g owned by
// thread g % threads as its (g / threads)-th, in shared memory beside the
// slot's eviction key: the stamp (LRU, FIFO), the frequency and tick (LFU),
// the float32 score (FTPL).  A slot's key changes only when the slot is
// written or its own item is requested, so its owner keeps it current and a
// request reads nothing of the catalog but its own count and noise.  Per
// request, in order:
//  1. each thread compares its slots with the item j and forms each slot's
//     key, a matching slot taking key 0, below every real key (a match
//     outranks every stamp, as the reference's where(match, INT32_MIN, ...));
//  2. a block-wide argmin over (key, slot index): in each warp one redux.sync
//     min a 32-bit word (the key's high word, its low word among the lanes
//     that hold the least high word, then the index among those that hold
//     the least key), the warps' minima through shared memory
//     (double-buffered, so one __syncthreads a request), then the same
//     again, so every thread holds the winner; the slot index breaks ties,
//     as argmin does (first index);
//  3. the winner's owner writes it: the hit slot, or the victim on a miss.
// LFU's key is (frequency, tick) (empty slots frequency -1, inactive ones
// INT32_MAX), the victim's frequency gating admission (hit or f >= minf);
// FTPL's is (score, item id), so equal least scores go to the smallest item
// id, and a miss swaps in only if its score is strictly above the least.
// Scores are float32(count) + noise, one float32 add (__fadd_rn: no
// contraction can arise, there is no product).
//
// Counts (LFU, FTPL).  Requests are taken a tile of `threads` at a time.
// Each thread loads one id of the tile and finds its rank among the equal
// ids before it in the tile, so its count after the request is the count
// before the tile plus rank + 1, read in parallel; the last occurrence of
// each id in the tile writes the count back after the tile's steps.
//
// Inactive slots (id -2, stamp or tick INT32_MAX: capacity padding) are
// never matched and never win the argmin.  The carry is updated in place:
// slots, stamps or ticks, counts and the request clock t.
//
// Bound on an H100: the bytes (ids read, the carry read and written once)
// take well under a microsecond; the kernel is latency-bound, a chain of
// `window` dependent block-wide reductions, each two or three redux.sync
// (twice with more than one warp) and one __syncthreads (none with a single
// warp).  The design holds at most kMaxSlots slots (shared memory); larger
// capacities run on the tree automata (LRU, LFU, FTPL) or wait for this
// kernel's redesign (FIFO).

#include <climits>
#include <math.h>

#include <cuda_runtime.h>

namespace {

constexpr int kLRU = 0, kFIFO = 1, kLFU = 2, kFTPL = 3;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSlots = 16384;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ unsigned long long biased(int x) {
  return (unsigned long long)((unsigned)x ^ 0x80000000u);
}

// float32 bits in an order that unsigned compares as the floats (finite and
// infinite values; -0 is made +0 first, so equal floats have equal keys)
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

// The warp's least (key, idx), in every lane: redux.sync min over the
// key's high word, then its low word among the lanes that hold that high
// word (skipped where every key's low word is 0: LRU, FIFO), then the slot
// index among the lanes that hold the least key.  Indices are >= 0.
template <bool kWide>
__device__ __forceinline__ void warp_argmin(unsigned long long& key, int& idx) {
  const unsigned hi = __reduce_min_sync(kFull, (unsigned)(key >> 32));
  unsigned lo = 0;
  if (kWide) lo = __reduce_min_sync(kFull, (unsigned)(key >> 32) == hi ? (unsigned)key : ~0u);
  const unsigned long long best = ((unsigned long long)hi << 32) | lo;
  idx = (int)__reduce_min_sync(kFull, key == best ? (unsigned)idx : ~0u);
  key = best;
}

template <int KIND, int S>
__global__ void __launch_bounds__(kMaxThreads)
    slot_automaton_kernel(int* __restrict__ slots, int* __restrict__ keys,
                          int* __restrict__ counts, const float* __restrict__ noise,
                          int* __restrict__ tclock, const int* __restrict__ ids, int window,
                          int n_slots, int* __restrict__ hits_out, float* __restrict__ stats) {
  constexpr bool kCounted = KIND == kLFU || KIND == kFTPL;
  constexpr bool kWide = kCounted;  // a key of two words (LFU, FTPL)
  extern __shared__ int smem[];
  __shared__ unsigned long long red_key[2][32];
  __shared__ int red_idx[2][32];
  __shared__ int s_occ;

  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int cap = nt * S;
  int* p = smem;
  int* s_slot = p;
  p += cap;
  int* s_key = p;  // stamps (LRU, FIFO) or ticks (LFU)
  if (KIND != kFTPL) p += cap;
  int* s_val = p;  // frequency (LFU) or the score's bits (FTPL)
  if (kCounted) p += cap;
  int* tile_ids = p;
  p += nt;
  int* tile_cnt = p;
  if (kCounted) p += nt;
  float* tile_score = reinterpret_cast<float*>(p);

#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int g = k * nt + tid;
    if (g < n_slots) {
      const int sl = slots[g];
      s_slot[g] = sl;
      if (KIND != kFTPL) s_key[g] = keys[g];
      if (KIND == kLFU) s_val[g] = sl >= 0 ? counts[sl] : (sl == -1 ? -1 : INT_MAX);
      if (KIND == kFTPL) {
        s_val[g] = __float_as_int(
            sl >= 0 ? __fadd_rn(__int2float_rn(counts[sl]), __ldg(noise + sl)) : INFINITY);
      }
    }
  }
  const int t0 = KIND != kFTPL ? *tclock : 0;
  int hits = 0, buf = 0;

  for (int base = 0; base < window; base += nt) {
    const int n = min(nt, window - base);
    __syncthreads();  // the previous tile's steps are done with the tile
    const int j = tid < n ? __ldg(ids + base + tid) : -1;
    tile_ids[tid] = j;
    int c = 0;
    bool last = true;
    if (kCounted) {
      __syncthreads();
      if (tid < n) {
        int rank = 0;
        for (int s = 0; s < n; ++s) {
          if (tile_ids[s] == j) {
            rank += s < tid;
            last &= s <= tid;
          }
        }
        c = counts[j] + rank + 1;
        tile_cnt[tid] = c;
        if (KIND == kFTPL) tile_score[tid] = __fadd_rn(__int2float_rn(c), __ldg(noise + j));
      }
    }
    __syncthreads();

    for (int q = 0; q < n; ++q) {
      const int jq = tile_ids[q];
      const int tq = t0 + base + q;
      const int fq = kCounted ? tile_cnt[q] : 0;
      const float sq = KIND == kFTPL ? tile_score[q] : 0.0f;
      unsigned long long best = kNoKey;
      int bidx = INT_MAX;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int g = k * nt + tid;
        if (g < n_slots) {
          const int sl = s_slot[g];
          unsigned long long key;
          if (sl == jq) {
            key = 0;
            if (KIND == kLFU) s_val[g] = fq;
            if (KIND == kFTPL) s_val[g] = __float_as_int(sq);
          } else if (KIND == kLRU || KIND == kFIFO) {
            key = biased(s_key[g]) << 32;
          } else if (KIND == kLFU) {
            key = (biased(s_val[g]) << 32) | biased(s_key[g]);
          } else {
            key = ((unsigned long long)ordered(__int_as_float(s_val[g])) << 32) | biased(sl);
          }
          if (key < best) {  // g rises with k: the first slot wins a tie
            best = key;
            bidx = g;
          }
        }
      }
      warp_argmin<kWide>(best, bidx);
      if (nwarps > 1) {
        if (lane == 0) {
          red_key[buf][warp] = best;
          red_idx[buf][warp] = bidx;
        }
        __syncthreads();
        best = lane < nwarps ? red_key[buf][lane] : kNoKey;
        bidx = lane < nwarps ? red_idx[buf][lane] : INT_MAX;
        warp_argmin<kWide>(best, bidx);
        buf ^= 1;
      }
      const bool hit = best == 0;
      hits += hit;
      if (bidx % nt == tid) {
        if (KIND == kLRU) {
          s_slot[bidx] = jq;  // a no-op on a hit
          s_key[bidx] = tq;   // refresh on a hit
        } else if (KIND == kFIFO) {
          if (!hit) {
            s_slot[bidx] = jq;
            s_key[bidx] = tq;
          }
        } else if (KIND == kLFU) {
          const int minf = (int)((unsigned)(best >> 32) ^ 0x80000000u);
          if (hit || fq >= minf) {
            s_slot[bidx] = jq;
            s_key[bidx] = tq;
            s_val[bidx] = fq;
          }
        } else if (!hit && sq > unordered((unsigned)(best >> 32))) {
          s_slot[bidx] = jq;
          s_val[bidx] = __float_as_int(sq);
        }
      }
    }
    if (kCounted && tid < n && last) counts[j] = c;
  }

  if (tid == 0) s_occ = 0;
  __syncthreads();
  int occ = 0;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int g = k * nt + tid;
    if (g < n_slots) {
      const int sl = s_slot[g];
      slots[g] = sl;
      if (KIND != kFTPL) keys[g] = s_key[g];
      occ += sl >= 0;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) occ += __shfl_xor_sync(kFull, occ, off);
  if (lane == 0) atomicAdd(&s_occ, occ);
  __syncthreads();
  if (tid == 0) {
    if (KIND != kFTPL) *tclock = t0 + window;
    *hits_out = hits;
    stats[0] = (float)hits;  // reward: the automata's reward is their hits
    stats[1] = 0.0f;         // aux: no threshold
    stats[2] = (float)s_occ;
  }
}

size_t smem_bytes(int kind, int threads, int per_thread) {
  const size_t cap = (size_t)threads * per_thread;
  const bool counted = kind == kLFU || kind == kFTPL;
  const size_t slot_words = 1 + (kind != kFTPL) + counted;
  const size_t tile_words = 1 + counted + (kind == kFTPL);
  return 4 * (cap * slot_words + (size_t)threads * tile_words);
}

template <int KIND, int S>
int launch(int threads, int n_slots, int window, int* slots, int* keys, int* counts,
           const float* noise, int* t, const int* ids, int* hits, float* stats,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(KIND, threads, S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        slot_automaton_kernel<KIND, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  slot_automaton_kernel<KIND, S><<<1, threads, smem, stream>>>(slots, keys, counts, noise, t,
                                                               ids, window, n_slots, hits, stats);
  return (int)cudaGetLastError();
}

template <int KIND>
int dispatch(int per_thread, int threads, int n_slots, int window, int* slots, int* keys,
             int* counts, const float* noise, int* t, const int* ids, int* hits, float* stats,
             cudaStream_t s) {
  switch (per_thread) {
    case 1:
      return launch<KIND, 1>(threads, n_slots, window, slots, keys, counts, noise, t, ids, hits,
                             stats, s);
    case 2:
      return launch<KIND, 2>(threads, n_slots, window, slots, keys, counts, noise, t, ids, hits,
                             stats, s);
    case 4:
      return launch<KIND, 4>(threads, n_slots, window, slots, keys, counts, noise, t, ids, hits,
                             stats, s);
    case 8:
      return launch<KIND, 8>(threads, n_slots, window, slots, keys, counts, noise, t, ids, hits,
                             stats, s);
    case 16:
      return launch<KIND, 16>(threads, n_slots, window, slots, keys, counts, noise, t, ids, hits,
                              stats, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 0 lru, 1 fifo, 2 lfu, 3 ftpl.  keys: stamps or ticks (null for
// ftpl); counts (lfu, ftpl) and noise (ftpl) may be null otherwise; t is the
// int32 request clock (null for ftpl).  hits: one int32; stats: three
// float32 (reward, aux, occupancy).
extern "C" int repro_slot_automaton(int kind, int per_thread, int threads, int n_slots,
                                    int window, void* slots, void* keys, void* counts,
                                    const void* noise, void* t, const void* ids, void* hits,
                                    void* stats, void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || n_slots < 1 ||
      n_slots > kMaxSlots || (long long)threads * per_thread < n_slots || window < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* sl = static_cast<int*>(slots);
  int* k = static_cast<int*>(keys);
  int* c = static_cast<int*>(counts);
  const float* nz = static_cast<const float*>(noise);
  int* tc = static_cast<int*>(t);
  const int* id = static_cast<const int*>(ids);
  int* h = static_cast<int*>(hits);
  float* st = static_cast<float*>(stats);
  switch (kind) {
    case kLRU:
      return dispatch<kLRU>(per_thread, threads, n_slots, window, sl, k, c, nz, tc, id, h, st, s);
    case kFIFO:
      return dispatch<kFIFO>(per_thread, threads, n_slots, window, sl, k, c, nz, tc, id, h, st, s);
    case kLFU:
      return dispatch<kLFU>(per_thread, threads, n_slots, window, sl, k, c, nz, tc, id, h, st, s);
    case kFTPL:
      return dispatch<kFTPL>(per_thread, threads, n_slots, window, sl, k, c, nz, tc, id, h, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The largest slot count the design holds, for the wrapper to check against.
extern "C" int repro_slot_automaton_max_slots() { return kMaxSlots; }
