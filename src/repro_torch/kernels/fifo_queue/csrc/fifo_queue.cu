// FIFO at any capacity: one chunk of requests, in order, in one launch.
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
