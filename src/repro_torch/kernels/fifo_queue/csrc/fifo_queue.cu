// FIFO at any capacity: one chunk of requests, in order, in one launch.
//
// The reference has no Pallas kernel here: it scans FIFO's per-request step
// over the chunk with lax.scan (src/repro/cachesim/engines.py: _fifo_step),
// each step a compare over every slot and an argmin over their stamps.  The
// port's plain version is ../ref.py's fifo_queue_ref; this kernel computes
// the same, bit for bit: the hits, the flags, and the carry (slots, stamps,
// the clock t) with the run's derived queue (head, tickets, occupancy,
// misses).
//
// FIFO never refreshes a stamp and a miss writes the clock, above every
// stamp, into the slot of the least (stamp, index): so the victims walk the
// A active slots in one fixed order (`order`, derived once a run), and the
// g-th miss of the run takes order[g mod A] and evicts what miss g - A
// admitted.  imap holds each item's admission ticket, the number of the miss
// that admitted it (../ref.py): after M misses item j is held iff
// M - A <= imap[j].  A miss writes its slot, stamp and ticket and reads
// nothing of the item it evicts.
//
// Tile plan (A >= kTileMinSlots = 32): a block of W = clamp(A / 1024, 1, 32)
// warps resolves a tile of S = 32 W requests at once, a thread a request
// (S <= A / 32, so few requests of a tile are unsure, below).  A request
// whose item is not held at the tile's start misses at its first
// occurrence in the tile, and its repeats hit: what the tile admits lives
// A >= S misses.  The first occurrence is the least position of the id,
// found through a hash of the tile's ids in shared memory (atomicMin of the
// position).  A request whose item is held hits unless a miss of the tile
// evicts it first, which needs its remaining life, imap[j] + A - M0, below
// S - 1: those requests, with the repeats of their id, are settled in
// position order by warp 0, 32 at a time by shuffles, which then scans the
// warps' miss counts.  Each
// miss takes its rank r among the tile's misses, its victim
// order[head + r] and the ticket M0 + r, and writes its own slot, stamp
// and ticket; each thread writes its own flag byte.  Four block barriers a
// tile.
//
// The loads are a tile ahead: while a tile resolves, the next tile's
// tickets, the window of order that holds its victims (2S entries from this
// tile's head) and the ids of the tile after it are in flight.  The next
// tile's tickets miss this tile's admissions, so this tile's hash keeps the
// ticket each admitted id got, and the next tile takes it from there (two
// hashes, by tile parity).
//
// Chain plan (A < 32: a tile may evict what it admits): the requests in
// order, one warp in step; each request's ticket is broadcast from its lane,
// a miss takes the victim of its rank, lane 0 writes, and a lane whose id
// was admitted takes the new ticket.
//
// A sweep's grid of combos: one launch a plan, a block a combo over the
// same ids (Args.rows names the combos of the plan, Args.actives their
// active slots), each on its own rows of the stacked carry and queue.  A
// tile-plan block is sized for the most warps among its launch's combos;
// the warps past its own combo's tile leave at once, and the tile's
// barriers are a named barrier over its own warps.  A row is bit for bit
// its combo's single launch.
//
// Bound on an H100: the bytes (the ids, the requested tickets, and each
// miss's order entry, slot, stamp and ticket) take ~4 us at a 1e6-request
// chunk; the tile plan is latency-bound, a round of shared atomics and
// four barriers a tile of 1024 requests, its loads hidden a tile ahead.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileMinSlots = 32;
constexpr int kTileWarps = 32;                // the most warps a tile: S <= 1024
constexpr int kSlotsPerWarp = 1024;           // active slots a warp of the tile
constexpr int kTileMax = 32 * kTileWarps;
constexpr int kHashSlots = 2 * kTileMax;      // the tile's ids at most half full
constexpr int kNone = -1;                     // an empty hash slot (ids are >= 0)

// The tile plan's shared memory (~81 KB, dynamic).  By tile parity: the
// tile's ids that may miss (kNone: free), the least position of each, an
// unsure id's remaining life, and the ticket a miss of the tile gave it
// (kNone: none).
struct TileShared {
  int key[2][kHashSlots];
  int first_at[2][kHashSlots];
  int life_at[2][kHashSlots];
  int ticket_at[2][kHashSlots];
  int window[2 * kTileMax];  // order[(M + e) mod A], M the previous tile's misses
  int slot_at[kTileMax];     // an unsure request's hash slot
  int unsure_at[kTileMax];   // the unsure requests' positions, in order
  unsigned miss_w[kTileWarps], unsure_w[kTileWarps];
  int prefix[kTileWarps];    // the misses of the warps before
  int total;                 // the tile's misses
};

struct Args {
  int* slots;
  int* stamps;
  int* tclock;
  const int* order;
  int active;
  int* head_p;
  int* misses_p;
  int* imap;
  int* occ_p;
  const int* ids;
  int window;
  unsigned char* flags;
  int* hits_out;
  float* stats;
  // a grid of combos: block b runs combo rows[b], whose carry rows lie
  // these many ints apart; its active slots are actives[row]; its ids
  // ids_stride apart (0: one chunk for every combo, a sweep's)
  const int* rows;
  const int* actives;
  long long slots_stride, order_stride, imap_stride, ids_stride;
};

// The block's combo: its rows of the carry, its flags and its outputs.
__device__ __forceinline__ Args row_args(Args g) {
  const long long row = g.rows[blockIdx.x];
  g.active = g.actives[row];
  g.slots += row * g.slots_stride;
  g.stamps += row * g.slots_stride;
  g.order += row * g.order_stride;
  g.imap += row * g.imap_stride;
  g.ids += row * g.ids_stride;
  g.tclock += row;
  g.head_p += row;
  g.misses_p += row;
  g.occ_p += row;
  if (g.flags != nullptr) g.flags += row * g.window;
  g.hits_out += row;
  g.stats += row * 3;
  return g;
}

// The warps of a tile over `active` slots: clamp(active / kSlotsPerWarp, 1,
// kTileWarps).
__device__ __forceinline__ int tile_warps(int active) {
  const int per = active / kSlotsPerWarp;
  return per < 1 ? 1 : per < kTileWarps ? per : kTileWarps;
}

// A barrier among the tile's `tile` threads: a grid's block is sized for
// its largest combo, and the warps past its own tile have left.
__device__ __forceinline__ void tile_sync(int tile) {
  asm volatile("bar.sync 1, %0;" ::"r"(tile) : "memory");
}

// the carry's scalars after the chunk: head, misses, occupancy, clock, hits
__device__ __forceinline__ void finish(const Args& g, int head, int m0, int misses, int hits) {
  const int occ0 = *g.occ_p;
  const int occ = misses >= g.active - occ0 ? g.active : occ0 + misses;
  *g.head_p = head;
  *g.misses_p = m0 + misses;
  *g.occ_p = occ;
  *g.tclock = *g.tclock + g.window;
  *g.hits_out = hits;
  g.stats[0] = (float)hits;  // reward: an automaton's reward is its hits
  g.stats[1] = 0.0f;         // aux: no threshold
  g.stats[2] = (float)occ;
}

__device__ __forceinline__ int hash_slot(int j) {
  return (int)(((unsigned)j * 2654435761u) >> 21);  // 11 bits: kHashSlots
}

// order[(head + e) mod A], for head < A and e < 2A
__device__ __forceinline__ int order_at(const int* __restrict__ order, int head, int e, int a) {
  int pos = head + e;
  pos = pos < a ? pos : pos - a;
  return __ldg(order + (pos < a ? pos : pos - a));
}

__global__ void __launch_bounds__(kTileMax) fifo_tile_kernel(Args g0) {
  extern __shared__ unsigned char smem_raw[];
  TileShared& sh = *reinterpret_cast<TileShared*>(smem_raw);
  const Args g = row_args(g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = tile_warps(g.active), tile = 32 * n_warps;
  if (warp >= n_warps) return;
  const unsigned below = (1u << lane) - 1u;
  for (int e = tid; e < 2 * kHashSlots; e += tile) {
    (&sh.key[0][0])[e] = kNone;
    (&sh.first_at[0][0])[e] = INT_MAX;
  }
  const int a = g.active, t0 = *g.tclock, m_start = *g.misses_p;
  int head = *g.head_p, m0 = m_start, hits = 0;
  // the first tile's ids, tickets and window; the second tile's ids
  int j = tid < g.window ? __ldg(g.ids + tid) : 0;
  int j_next = tile + tid < g.window ? __ldg(g.ids + tile + tid) : 0;
  int ticket_raw = tid < g.window ? __ldcg(g.imap + j) : 0;
  int w_lo = order_at(g.order, head, tid, a), w_hi = order_at(g.order, head, tile + tid, a);
  int window_m = m0, h_prev = -1;
  tile_sync(tile);
  for (int base = 0, p = 0; base < g.window; base += tile, p ^= 1) {
    const int n = min(tile, g.window - base);
    const bool valid = tid < n;
    // this tile's window of victims, loaded a tile ago; then the next
    // tile's loads, in flight while this one resolves
    sh.window[tid] = w_lo;
    sh.window[tile + tid] = w_hi;
    const int off = m0 - window_m;
    int ticket_next = 0, j_after = 0;
    if (base + tile + tid < g.window) ticket_next = __ldcg(g.imap + j_next);
    if (base + 2 * tile + tid < g.window) j_after = __ldg(g.ids + base + 2 * tile + tid);
    w_lo = order_at(g.order, head, tid, a);
    w_hi = order_at(g.order, head, tile + tid, a);
    window_m = m0;
    // this tile's ticket, loaded a tile ago: the previous tile's admission
    // where it made one
    int ticket = ticket_raw;
    if (valid && base > 0) {
      for (int e = hash_slot(j); sh.key[p ^ 1][e] != kNone; e = (e + 1) & (kHashSlots - 1)) {
        if (sh.key[p ^ 1][e] == j) {
          ticket = sh.ticket_at[p ^ 1][e] != kNone ? sh.ticket_at[p ^ 1][e] : ticket;
          break;
        }
      }
    }
    // held iff M0 - A <= ticket; `life`: the tile's misses it outlives
    const int low = m0 - a;
    const bool held = valid && ticket >= low;
    const int life = held ? ticket - low : -1;
    const bool unsure = held && life < tile - 1;
    // the ids that may miss: their least position
    int h = -1;
    if (valid && (!held || unsure)) {
      h = hash_slot(j);
      for (int old = atomicCAS(&sh.key[p][h], kNone, j); old != kNone && old != j;
           old = atomicCAS(&sh.key[p][h], kNone, j)) {
        h = (h + 1) & (kHashSlots - 1);
      }
      atomicMin(&sh.first_at[p][h], tid);
      sh.ticket_at[p][h] = kNone;
      if (unsure) sh.life_at[p][h] = life;
    }
    tile_sync(tile);
    if (h_prev >= 0) {  // every lookup of the previous tile's hash is done
      sh.key[p ^ 1][h_prev] = kNone;
      sh.first_at[p ^ 1][h_prev] = INT_MAX;
    }
    const bool miss = valid && !held && sh.first_at[p][h] == tid;
    if (unsure) sh.slot_at[tid] = h;
    const unsigned miss_ballot = __ballot_sync(kFull, miss);
    const unsigned unsure_ballot = __ballot_sync(kFull, unsure);
    if (lane == 0) {
      sh.miss_w[warp] = miss_ballot;
      sh.unsure_w[warp] = unsure_ballot;
    }
    tile_sync(tile);
    if (warp == 0) {
      // lane w holds warp w's words.  In position order: an unsure request
      // misses iff the misses before it outlast its item; a miss readmits
      // the item, which then outlives the tile.  The unsure requests are
      // listed in order and settled 32 at a time, each one a few shuffles.
      unsigned mword = lane < n_warps ? sh.miss_w[lane] : 0u;
      const unsigned uword = lane < n_warps ? sh.unsure_w[lane] : 0u;
      if (__ballot_sync(kFull, uword != 0u) != 0u) {
        const int c = __popc(mword), u = __popc(uword);
        int c_incl = c, u_incl = u;
        for (int o = 1; o < 32; o <<= 1) {
          const int x = __shfl_up_sync(kFull, c_incl, o), y = __shfl_up_sync(kFull, u_incl, o);
          c_incl += lane >= o ? x : 0;
          u_incl += lane >= o ? y : 0;
        }
        const int n_unsure = __shfl_sync(kFull, u_incl, 31);
        int at = u_incl - u;
        for (unsigned x = uword; x != 0u; x &= x - 1u) {
          sh.unsure_at[at++] = 32 * lane + __ffs(x) - 1;
        }
        __syncwarp();
        int added = 0;  // the unsure misses so far
        for (int l0 = 0; l0 < n_unsure; l0 += 32) {
          const int l = l0 + lane, batch = min(32, n_unsure - l0);
          const int pos = l < n_unsure ? sh.unsure_at[l] : 0;
          const int slot = l < n_unsure ? sh.slot_at[pos] : -1;
          int life = l < n_unsure ? sh.life_at[p][slot] : 0;
          // the certain misses before this request
          const unsigned mw = __shfl_sync(kFull, mword, pos >> 5);
          const int before_w = __shfl_sync(kFull, c_incl - c, pos >> 5);
          const int certain = before_w + __popc(mw & ((1u << (pos & 31)) - 1u));
          unsigned missed = 0u;
          for (int i = 0; i < batch; ++i) {
            const int k = __shfl_sync(kFull, certain, i) + added;
            const int life_i = __shfl_sync(kFull, life, i);
            const int slot_i = __shfl_sync(kFull, slot, i);
            if (k > life_i) {
              ++added;
              missed |= 1u << i;
              if (lane > i && slot == slot_i) life = k + a;
              if (lane == 0) sh.life_at[p][slot_i] = k + a;
            }
          }
          if ((missed >> lane) & 1u) atomicOr(&sh.miss_w[pos >> 5], 1u << (pos & 31));
          __syncwarp();
        }
        mword = lane < n_warps ? sh.miss_w[lane] : 0u;
      }
      int c = __popc(mword), incl = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(kFull, incl, o);
        incl += lane >= o ? x : 0;
      }
      if (lane < n_warps) sh.prefix[lane] = incl - c;
      if (lane == 31) sh.total = incl;
    }
    tile_sync(tile);
    const unsigned word = sh.miss_w[warp];
    const int m = sh.total;
    const bool missed = (word >> lane) & 1u;
    if (missed) {
      const int rank = sh.prefix[warp] + __popc(word & below);
      const int v = sh.window[off + rank];
      g.imap[j] = m0 + rank;
      g.slots[v] = j;
      g.stamps[v] = t0 + base + tid;
      sh.ticket_at[p][h] = m0 + rank;  // for the next tile, whose ticket predates it
    }
    if (g.flags != nullptr && valid) g.flags[base + tid] = !missed;
    h_prev = h;
    hits += n - m;
    m0 += m;
    head += m;
    head = head < a ? head : head - a;
    j = j_next;
    j_next = j_after;
    ticket_raw = ticket_next;
    tile_sync(tile);  // the tile's writes are seen by the next tile's reads
  }
  if (tid == 0) finish(g, head, m_start, m0 - m_start, hits);
}

__global__ void __launch_bounds__(32) fifo_chain_kernel(Args g0) {
  const Args g = row_args(g0);
  const int lane = threadIdx.x;
  const int a = g.active, t0 = *g.tclock, m_start = *g.misses_p;
  int head = *g.head_p, m = m_start, hits = 0;
  for (int base = 0; base < g.window; base += 32) {
    const int n = min(32, g.window - base);
    const bool valid = lane < n;
    const int j = valid ? __ldg(g.ids + base + lane) : -1;
    int ticket = valid ? __ldcg(g.imap + j) : 0;
    const int victim = __ldg(g.order + (head + lane) % a);  // of the tile's lane-th miss
    const int m0 = m;
    bool hit = false;
    for (int q = 0; q < n; ++q) {
      const int tq = __shfl_sync(kFull, ticket, q);
      if (m - a <= tq) {
        hit = hit || lane == q;
        continue;
      }
      const int v = __shfl_sync(kFull, victim, m - m0);
      const int jq = __shfl_sync(kFull, j, q);
      if (lane == 0) {
        g.imap[jq] = m;
        g.slots[v] = jq;
        g.stamps[v] = t0 + base + q;
      }
      if (j == jq) ticket = m;
      ++m;
    }
    if (g.flags != nullptr && valid) g.flags[base + lane] = hit;
    hits += n - (m - m0);
    head = (head + (m - m0)) % a;
    __syncwarp();  // the tile's writes are seen by the next tile's reads
  }
  if (lane == 0) finish(g, head, m_start, m - m_start, hits);
}

}  // namespace

// One chunk of ids for a grid of combos, a block each: `count` blocks run
// the combos rows[0 .. count) of carries stacked a row a combo.  A combo's
// slots and stamps: (K,) int32, rows slots_stride apart; tclock its () int32
// clock; order: its actives[row] active slots by (stamp, index), rows
// order_stride apart; head, misses, occ: () int32; imap: one int32 ticket
// an item, covering every id, rows imap_stride apart; ids: rows ids_stride
// apart (0: the combos share one chunk; the window: a fleet's tenants, a
// row of ids each).  flags: null, or one byte a request, a window a row.  hits: one int32 a combo; stats: three
// float32.  The scalars lie one apart.  All the combos take one plan:
// `tile` (every combo's active >= kTileMinSlots), a block of `warps` warps,
// the most clamp(active / kSlotsPerWarp, 1, kTileWarps) among them; else
// the chain.  A single chunk is the grid of one combo.
extern "C" int repro_fifo_queue(int window, const void* ids, void* slots, void* stamps,
                                void* tclock, const void* order, void* head, void* misses,
                                void* imap, void* occ, void* flags, void* hits, void* stats,
                                int count, const void* rows, const void* actives,
                                long long slots_stride, long long order_stride,
                                long long imap_stride, long long ids_stride, int tile, int warps,
                                void* stream) {
  if (window < 1 || count < 1 || rows == nullptr || actives == nullptr || warps < 1 ||
      warps > kTileWarps || (!tile && warps != 1) || (ids_stride != 0 && ids_stride < window)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args g{static_cast<int*>(slots), static_cast<int*>(stamps), static_cast<int*>(tclock),
               static_cast<const int*>(order), 0, static_cast<int*>(head),
               static_cast<int*>(misses), static_cast<int*>(imap), static_cast<int*>(occ),
               static_cast<const int*>(ids), window, static_cast<unsigned char*>(flags),
               static_cast<int*>(hits), static_cast<float*>(stats),
               static_cast<const int*>(rows), static_cast<const int*>(actives), slots_stride,
               order_stride, imap_stride, ids_stride};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile) {
    const int smem = (int)sizeof(TileShared);
    const cudaError_t e = cudaFuncSetAttribute(
        fifo_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    fifo_tile_kernel<<<count, 32 * warps, smem, s>>>(g);
  } else {
    fifo_chain_kernel<<<count, 32, 0, s>>>(g);
  }
  return (int)cudaGetLastError();
}
