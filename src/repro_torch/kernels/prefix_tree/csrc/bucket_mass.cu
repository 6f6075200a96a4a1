// Bucket masses at K thresholds, one pass over a V-bucket value histogram:
//
//   mean_b   = cnt_b > 0 ? sum_b / cnt_b : 0
//   mass[k]  = sum_b cnt_b * clip(mean_b - tau_k, 0, 1)
//
// Replaces the Pallas TPU kernel src/repro/kernels/prefix_tree/kernel.py
// (bucket_mass_kernel, launched by bucket_masses): the lazy OGB threshold
// solve's K-way bracketing over buckets.  That kernel carries its sums across
// grid steps in the output block, which needs the TPU's in-order grid, and
// needs K to be a multiple of 8.  Here, as in capped_simplex/csrc/mass.cu:
//   1. bucket_mass_partials_kernel: grid (G, ceil(K / 8)); each thread walks
//      the buckets with a grid stride, computes the mean once per bucket and
//      accumulates 8 thresholds in registers; warp shuffles and a fixed sum
//      over the block's warps give one partial per (threshold, block).
//   2. bucket_mass_finish_kernel: one block per threshold sums the G partials
//      in a fixed order.
// Each term is a float32 product; the sums are in double from the first add
// and rounded to float32 once.  No atomics, so the masses (and the threshold
// the solve picks from them) are the same on every run, and the same as the
// plain version's, which also sums in double: the solve sits where the mass
// changes slowly, so a float32 summation order would move the threshold.
// Any K >= 1 and any V.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s float32): at V = 65 536 and K = 63,
// 0.52 MB moved (0.16 us) against 2 + 5K operations a bucket (20.8 M, 0.31
// us): operations, far below launch latency.  __fdiv_rn/__fsub_rn/__fmul_rn
// keep nvcc from contracting what the plain PyTorch version rounds twice, so
// every term is bit for bit the plain version's.
//
// repro_solve_buckets: ogb_tree's whole threshold solve in one launch.  The
// solve bisects `iters` times in rounds of six halvings: a round evaluates
// the mass at the 63 interior points of a 64-way grid over the bracket and
// keeps the last point whose mass is at least C and the point after it.  As
// a bucket_masses launch (two kernels) and ~8 PyTorch ops a round, each
// round was pure launch latency on an H100 (11 us against a 0.31 us bound).
// Here:
//   * one persistent cooperative launch, one block of kSolveThreads per
//     resident slot (one a SM); a barrier across the grid ends each round
//     (../../csrc/persistent.cuh);
//   * the bucket means are computed once and kept in shared memory with the
//     counts, kChipBuckets a block (0.5 MB for V = 65 536 over 132 blocks),
//     the empty buckets left out (each adds an exact 0); past that each round
//     re-reads the counts and sums and recomputes the means, rounded the same
//     way;
//   * a block's threads split into 16 slices of its buckets by 64 grid
//     points (the last idle); each term is the plain version's float32 term,
//     summed in double per thread and over the slices in order;
//     a block's 63 partials go to its slots of the (rounds, 63, G) partials;
//     after the barrier every block sums each point's G partials in one
//     fixed order, 16 lanes a point with all their loads in flight at once,
//     so every block holds the same 63 masses and picks the same sub-bracket
//     on the device, with no second barrier and no host round trip;
//   * grid points are lo + (hi - lo) * (j / 2^h) with the plain version's
//     three float32 roundings, and the chosen ends are those same points.
// Fixed-order double sums rounded once: two runs give the same threshold,
// bit for bit, and the plain version's wherever no mass rounds to float32 on
// a tie.
// Bound of the whole solve on an H100 (3.35 TB/s, 67 TFLOP/s float32): the
// counts read once and the sums of the non-empty buckets, against
// 2 + 5 * (2^h - 1) operations a non-empty bucket a round of h halvings (an
// empty one adds an exact 0).  The work follows the histogram: at 30
// halvings over a mid-run ogb_tree histogram of 65 536 buckets, 23 of them
// non-empty, the 0.26 MB of counts (0.078 us): bytes; were every bucket
// non-empty, 104 M operations (1.55 us): operations.

#include <climits>

#include <cuda_runtime.h>

#include "../../csrc/persistent.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTauChunk = 8;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
bucket_mass_partials_kernel(const float* __restrict__ cnt, const float* __restrict__ total,
                            const float* __restrict__ taus, int k, long long v,
                            double* __restrict__ pmass) {
  const int k0 = blockIdx.y * kTauChunk;
  const int nk = min(kTauChunk, k - k0);
  float t[kTauChunk];
  double m[kTauChunk];
#pragma unroll
  for (int j = 0; j < kTauChunk; ++j) {
    t[j] = j < nk ? taus[k0 + j] : 0.0f;
    m[j] = 0.0;
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < v; i += stride) {
    const float c = cnt[i];
    const float mean = c > 0.0f ? __fdiv_rn(total[i], fmaxf(c, 1.0f)) : 0.0f;
#pragma unroll
    for (int j = 0; j < kTauChunk; ++j) {
      if (j < nk) {
        const float z = fminf(fmaxf(__fsub_rn(mean, t[j]), 0.0f), 1.0f);
        m[j] += (double)__fmul_rn(c, z);
      }
    }
  }
  __shared__ double sm[kTauChunk][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kTauChunk; ++j) {
    const double ms = warp_sum(m[j]);
    if (lane == 0) sm[j][warp] = ms;
  }
  __syncthreads();
  if (threadIdx.x < nk) {
    const int j = threadIdx.x;
    double ms = 0.0;
    for (int w = 0; w < kWarps; ++w) ms += sm[j][w];
    pmass[(long long)(k0 + j) * gridDim.x + blockIdx.x] = ms;
  }
}

__global__ void __launch_bounds__(kThreads)
bucket_mass_finish_kernel(const double* __restrict__ pmass, int blocks,
                          float* __restrict__ mass) {
  const int k = blockIdx.x;
  double ms = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kThreads) ms += pmass[(long long)k * blocks + b];
  __shared__ double sm[kThreads];
  sm[threadIdx.x] = ms;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) sm[threadIdx.x] += sm[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) mass[k] = (float)sm[0];
}

}  // namespace

// pmass holds k * blocks double partials; the wrapper allocates it.
extern "C" int repro_bucket_masses(const void* cnt, const void* total, const void* taus, int k,
                                   long long v, int blocks, void* pmass, void* mass,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks, (unsigned)((k + kTauChunk - 1) / kTauChunk));
  bucket_mass_partials_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(cnt), static_cast<const float*>(total),
      static_cast<const float*>(taus), k, v, static_cast<double*>(pmass));
  bucket_mass_finish_kernel<<<(unsigned)k, kThreads, 0, s>>>(
      static_cast<const double*>(pmass), blocks, static_cast<float*>(mass));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The K-way threshold solve in one persistent launch.

namespace {

constexpr int kSolveThreads = 1024;
constexpr int kSolveHalvings = 6;                        // halvings a round
constexpr int kSolvePoints = (1 << kSolveHalvings) - 1;  // grid points a round
constexpr int kSolveSlots = kSolvePoints + 1;            // a thread's point index
constexpr int kSolveSlices = kSolveThreads / kSolveSlots;  // bucket slices a block
constexpr int kChipBuckets = 4096;  // buckets a block keeps in shared memory
constexpr int kPointLanes = 16;     // lanes that sum one point's G partials
constexpr int kPointUnroll = 9;     // partials a lane loads at once: 16 * 9 >= 132 blocks
static_assert(kPointLanes * kSolveSlots == kSolveThreads, "a lane group a point");

__device__ __forceinline__ float bucket_mean(float c, float total) {
  return c > 0.0f ? __fdiv_rn(total, fmaxf(c, 1.0f)) : 0.0f;
}

// Point j of the 2^h-way grid over [lo, lo + d], rounded as the plain version
// rounds lo + (hi - lo) * (j / 2^h); j / 2^h is exact, so it is j * 2^-h.
__device__ __forceinline__ float grid_point(float lo, float d, int j, int h) {
  return __fadd_rn(lo, __fmul_rn(d, __fmul_rn((float)j, __int_as_float((127 - h) << 23))));
}

template <bool kOnChip>
__global__ void __launch_bounds__(kSolveThreads, 1)
solve_buckets_kernel(const float* __restrict__ cnt, const float* __restrict__ total,
                     const float* __restrict__ cap_p, const float* __restrict__ lo_p,
                     const float* __restrict__ hi_p, long long v, int iters,
                     double* __restrict__ pmass, float* __restrict__ lo_out) {
  __shared__ float2 chip[kOnChip ? kChipBuckets : 1];  // (count, mean), non-empty buckets
  __shared__ int warp_kept[kSolveThreads / 32];
  __shared__ double slice_sums[kSolveSlices][kSolveSlots];
  __shared__ float mass[kSolveSlots];
  const int blocks = gridDim.x;
  const long long per = (v + blocks - 1) / blocks;
  const long long b0 = min(v, per * blockIdx.x);
  int nb = (int)(min(v, b0 + per) - b0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (kOnChip) {
    // keep the block's non-empty buckets, in order: an empty one adds an
    // exact 0 to every mass (the plain version skips them too), and a value
    // histogram is mostly empty
    int kept = 0;
    for (int i0 = 0; i0 < nb; i0 += kSolveThreads) {
      const int i = i0 + threadIdx.x;
      const float c = i < nb ? cnt[b0 + i] : 0.0f;
      const bool keep = c != 0.0f;
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) warp_kept[warp] = __popc(ballot);
      __syncthreads();
      int at = kept + __popc(ballot & ((1u << lane) - 1u));
      for (int w = 0; w < kSolveThreads / 32; ++w) {
        at += w < warp ? warp_kept[w] : 0;
        kept += warp_kept[w];
      }
      if (keep) chip[at] = make_float2(c, bucket_mean(c, total[b0 + i]));
      __syncthreads();
    }
    nb = kept;
  }
  const float cap = *cap_p;
  float lo = *lo_p, hi = *hi_p;
  // this thread's grid point j = slot + 1 and its slice of the block's buckets
  const int slot = threadIdx.x % kSolveSlots, slice = threadIdx.x / kSolveSlots;
  for (int round = 0, done = 0; done < iters; ++round) {
    const int h = min(kSolveHalvings, iters - done);
    done += h;
    const int points = (1 << h) - 1;
    const float d = __fsub_rn(hi, lo);
    const float tau = grid_point(lo, d, slot + 1, h);
    // the plain version's float32 term for every bucket of the slice, summed
    // in double (a warp reads one bucket at a time: a broadcast)
    double acc = 0.0;
    if (slot < points) {
      for (int i = slice; i < nb; i += kSolveSlices) {
        float c, mean;
        if constexpr (kOnChip) {
          const float2 e = chip[i];
          c = e.x;
          mean = e.y;
        } else {
          c = cnt[b0 + i];
          mean = bucket_mean(c, total[b0 + i]);
        }
        acc += (double)__fmul_rn(c, fminf(fmaxf(__fsub_rn(mean, tau), 0.0f), 1.0f));
      }
    }
    slice_sums[slice][slot] = acc;
    __syncthreads();
    double* pm = pmass + (long long)round * kSolvePoints * blocks;
    if (threadIdx.x < points) {
      double s = 0.0;
      for (int k = 0; k < kSolveSlices; ++k) s += slice_sums[k][threadIdx.x];
      pm[(long long)threadIdx.x * blocks + blockIdx.x] = s;
    }
    persistent::grid_barrier();
    // every block: each point's G partials in one fixed order, summed by a
    // group of kPointLanes lanes with every load in flight at once
    {
      const int p = threadIdx.x / kPointLanes, l = threadIdx.x % kPointLanes;
      const bool mine = p < points;
      double s = 0.0;
      for (int g0 = l; g0 < blocks; g0 += kPointLanes * kPointUnroll) {
        double part[kPointUnroll];
#pragma unroll
        for (int u = 0; u < kPointUnroll; ++u) {
          const int b = g0 + kPointLanes * u;
          part[u] = mine && b < blocks ? __ldcg(pm + (long long)p * blocks + b) : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kPointUnroll; ++u) s += part[u];
      }
      for (int o = kPointLanes / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (mine && l == 0) mass[p] = (float)s;
    }
    __syncthreads();
    // mass is non-increasing in tau: the points with mass >= C come first;
    // keep the last of them (or lo) and the point after it (or hi)
    const int above =
        __popc(__ballot_sync(0xffffffffu, lane < points && mass[lane] >= cap)) +
        __popc(__ballot_sync(0xffffffffu, lane + 32 < points && mass[lane + 32] >= cap));
    const float new_lo = above == 0 ? lo : grid_point(lo, d, above, h);
    hi = above == points ? hi : grid_point(lo, d, above + 1, h);
    lo = new_lo;
    // slice_sums was last read before this round's barrier, and mass is
    // written again only past the next one
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *lo_out = lo;
}

const void* solve_kernel(int on_chip) {
  return on_chip ? (const void*)solve_buckets_kernel<true>
                 : (const void*)solve_buckets_kernel<false>;
}

}  // namespace

// Blocks of the bucket solve that one SM holds at once.
extern "C" int repro_solve_buckets_occupancy(int on_chip, int* blocks_per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, solve_kernel(on_chip),
                                                            kSolveThreads, 0);
}

// pmass holds ceil(iters / 6) * 63 * blocks double partials; the wrapper
// allocates it.  on_chip: the means in shared
// memory, which needs ceil(v / blocks) <= kChipBuckets.
extern "C" int repro_solve_buckets(const void* cnt, const void* total, const void* cap,
                                   const void* lo, const void* hi, long long v, int iters,
                                   int blocks, int on_chip, void* pmass, void* lo_out,
                                   void* stream) {
  if (blocks < 1 || iters < 0 || (on_chip && (v + blocks - 1) / blocks > kChipBuckets)) {
    return (int)cudaErrorInvalidValue;
  }
  void* args[] = {&cnt, &total, &cap, &lo, &hi, &v, &iters, &pmass, &lo_out};
  return persistent::launch(solve_kernel(on_chip), blocks, kSolveThreads, args,
                            static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// The sized OGB's threshold solve: K size classes, Newton on rho, one launch.
//
// The reference solves sum_k s_k * m_k(s_k * rho) = C, m_k class k's
// bucket mass at its own threshold t_k = s_k * rho, by `iters` (30)
// safeguarded Newton steps, each reading 2 prefix sums a class
// (src/repro/cachesim/tree_engines.py: make_sized_ogb_tree_chunk, the
// per-class form of bucket_mass_kernel's mass).  The plain version is
// ../ref.py's solve_sized_ref; this computes the same, sum for sum.
//
// One block.  Class k's buckets are the leaves of row k of the stacked
// count and sum trees (row_stride nodes apart); the tree's first level above
// the leaves holds each group of 64 buckets' count, so the groups that hold
// an item are found from it, in (class, group) order, by one ordered
// compaction over the block, and the first kCacheGroups of them keep their
// 64 (count, mean) pairs in shared memory (the rest are re-read from L2
// each step, the same values).  Then the steps, in one of two plans by the
// number G of those groups, decided on the card:
//  * block plan (G > 32), per step:
//    1. warp w takes the groups w, w + 32, ...: lane l the buckets l and
//       l + 32, each term cnt * clip(mean - t_k, 0, 1) and its interior
//       count in float64, the warp's sum by an xor butterfly, added in order
//       to the warp's running sum of the class, flushed where the class
//       changes;
//    2. a warp a class sums the 32 warps' sums by a butterfly; thread 0
//       adds the classes in order (s_k * m_k and float32(s_k^2) * i_k in
//       float64), rounds once to float32 and takes the Newton step, the
//       midpoint where the point is not strictly inside the bracket, as the
//       reference does.
//  * few-groups plan (G <= 32; a mid-run histogram has a few groups): the
//    block keeps W = max(G, K) warps and the others leave; two barriers a
//    step among those W warps alone (a named barrier), none by the block:
//    warp g sums group g as the block plan's warp g does (lane l the
//    buckets l and l + 32, an xor butterfly) and lane 0 writes it; then
//    warp k sums class k over the groups' sums, lane g holding group g's
//    (0 where its group is of another class), by a butterfly, as the block
//    plan's warp k sums its warps' sums; then every thread adds the classes
//    in order and takes the same Newton step.  With G <= 32 the block
//    plan's warp w holds group w alone (0 + x is exact), so both plans add
//    in the same order.
// Every float op is the plain version's, rounded as it rounds (__fmul_rn,
// __fsub_rn, __fdiv_rn, __dadd_rn, __dmul_rn: no contraction), so the
// iterate is its bit for bit in either plan.  `tally`, where given, counts
// the launches of each plan and the G they met (read off the hot path).
// The prologue reads the trees' first level four groups a thread at once,
// compacts them by one block scan a pass, and keeps the group list and the
// class sizes in shared memory for the steps.
// Bound: the counts of the groups that hold an item, and their sums, read
// once, and 5 operations a bucket a step over them; latency-bound at a
// mid-run histogram (a few groups): the block plan's three __syncthreads a
// step, the few-groups plan's two barriers and two dependent butterflies.

namespace {

constexpr int kSizedThreads = 1024;
constexpr int kSizedWarps = kSizedThreads / 32;
constexpr int kSizedMaxClasses = 32;
constexpr int kGroup = 64;
constexpr int kCacheGroups = 192;  // groups whose pairs stay in shared memory: 96 KB
constexpr int kTallyBins = 256;    // tally: [few-groups launches, block launches, G bins]

struct SizedShared {
  float2 pairs[kCacheGroups * kGroup];          // (count, mean)
  double part[2][kSizedMaxClasses][kSizedWarps];  // the warps' sums by class
  double gsum[2][2][kSizedWarps];     // few groups, by step parity: (mass, interior) a group
  double csum[2][2][kSizedMaxClasses];  // and a class
  int list[kCacheGroups];             // the first groups that hold an item
  float sk[kSizedMaxClasses];         // the class sizes
  int warp_kept[kSizedWarps];
  int n_groups;
  float t, lo, hi;
};

__device__ __forceinline__ float2 bucket(const float* cnt, const float* total, long long at) {
  const float c = __ldg(cnt + at);
  return make_float2(c, bucket_mean(c, __ldg(total + at)));
}

__device__ __forceinline__ void warp_sum2(double& a, double& b) {
  for (int o = 16; o > 0; o >>= 1) {
    a = __dadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = __dadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
}

// The few-groups plan's steps (G <= 32 groups, every pair in shared memory),
// run by the block's first `threads` threads, W = threads / 32 >= max(G, K)
// warps, which sync by named barrier 1.  Returns the last iterate.
__device__ float sized_few_groups(SizedShared& sh, long long per_class, int classes, float cap,
                                  float lo, float hi, int iters, int threads) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_groups = sh.n_groups;
  const int my_cls = warp < n_groups ? (int)(sh.list[warp] / per_class) : -1;
  const int lane_cls = lane < n_groups ? (int)(sh.list[lane] / per_class) : -1;
  const float s_mine = my_cls >= 0 ? sh.sk[my_cls] : 0.0f;
  float2 b[2];
  if (warp < n_groups) {
    b[0] = sh.pairs[warp * kGroup + lane];
    b[1] = sh.pairs[warp * kGroup + lane + 32];
  }
  float t = lo;
  for (int it = 0; it < iters; ++it) {
    const int p = it & 1;
    // 1. warp g: group g's sums, as the block plan's warp g takes them
    if (warp < n_groups) {
      const float tk = __fmul_rn(s_mine, t);
      double m2 = 0.0, i2 = 0.0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float z = fminf(fmaxf(__fsub_rn(b[h].y, tk), 0.0f), 1.0f);
        m2 = __dadd_rn(m2, (double)__fmul_rn(b[h].x, z));
        i2 = __dadd_rn(i2, z > 0.0f && z < 1.0f ? (double)b[h].x : 0.0);
      }
      warp_sum2(m2, i2);
      if (lane == 0) {
        sh.gsum[p][0][warp] = __dadd_rn(0.0, m2);
        sh.gsum[p][1][warp] = __dadd_rn(0.0, i2);
      }
    }
    asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
    // 2. warp k: class k's sums over the groups, lane g holding group g's
    if (warp < classes) {
      double m = lane_cls == warp ? sh.gsum[p][0][lane] : 0.0;
      double n_in = lane_cls == warp ? sh.gsum[p][1][lane] : 0.0;
      warp_sum2(m, n_in);
      if (lane == 0) {
        sh.csum[p][0][warp] = m;
        sh.csum[p][1][warp] = n_in;
      }
    }
    asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
    // 3. every thread: the classes in order, then the Newton step
    double mass = 0.0, slope = 0.0;
    for (int k = 0; k < classes; ++k) {
      const float sk = sh.sk[k];
      mass = __dadd_rn(mass, __dmul_rn((double)sk, sh.csum[p][0][k]));
      slope = __dadd_rn(slope, __dmul_rn((double)__fmul_rn(sk, sk), sh.csum[p][1][k]));
    }
    const float m32 = __double2float_rn(mass), s32 = __double2float_rn(slope);
    const bool too_much = m32 >= cap;
    lo = too_much ? t : lo;
    hi = too_much ? hi : t;
    const float t_newton = __fadd_rn(t, __fdiv_rn(__fsub_rn(m32, cap), fmaxf(s32, 1e-12f)));
    const float t_mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const bool ok = s32 > 0.0f && t_newton > lo && t_newton < hi;
    t = ok ? t_newton : t_mid;
  }
  return t;
}

__global__ void __launch_bounds__(kSizedThreads, 1)
solve_sized_kernel(const float* __restrict__ cnt, const float* __restrict__ total,
                   long long row_stride, long long v, int classes, const float* __restrict__ s,
                   const float* __restrict__ cap_p, const float* __restrict__ lo_p,
                   const float* __restrict__ hi_p, int iters, int* __restrict__ groups,
                   float* __restrict__ t_out, int* __restrict__ tally) {
  extern __shared__ unsigned char smem_raw[];
  SizedShared& sh = *reinterpret_cast<SizedShared*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the scalars, in flight beside the first level's reads
  const float cap = __ldg(cap_p), lo0 = __ldg(lo_p), hi0 = __ldg(hi_p);
  const float s_mine = threadIdx.x < classes ? __ldg(s + threadIdx.x) : 0.0f;
  const long long per_class = v / kGroup;  // groups a class: the first level's nodes
  const long long total_groups = per_class * classes;
  // the groups that hold an item, in (class, group) order, into `groups`
  // (and the first kCacheGroups into shared memory): a thread four
  // consecutive groups of the first level a pass, one block scan a pass
  int kept = 0;
  for (long long i0 = 0; i0 < total_groups; i0 += 4 * kSizedThreads) {
    const long long first = i0 + 4LL * threadIdx.x;
    bool keep[4];
    int mine = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long i = first + r;
      keep[r] = false;
      if (i < total_groups) {
        const long long k = i / per_class;
        keep[r] = __ldg(cnt + k * row_stride + v + (i - k * per_class)) != 0.0f;
      }
      mine += keep[r];
    }
    int incl = mine;  // the warp's inclusive scan
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      incl += lane >= o ? x : 0;
    }
    if (lane == 31) sh.warp_kept[warp] = incl;
    __syncthreads();
    const int warp_total = sh.warp_kept[lane];  // kSizedWarps == 32: a lane a warp
    int wincl = warp_total;
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, wincl, o);
      wincl += lane >= o ? x : 0;
    }
    int at = kept + __shfl_sync(0xffffffffu, wincl - warp_total, warp) + incl - mine;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (keep[r]) {
        groups[at] = (int)(first + r);
        if (at < kCacheGroups) sh.list[at] = (int)(first + r);
        ++at;
      }
    }
    kept += __shfl_sync(0xffffffffu, wincl, 31);
    __syncthreads();  // warp_kept is the next pass's
  }
  const int n_groups = kept;
  for (int e = threadIdx.x; e < min(n_groups, kCacheGroups) * kGroup; e += kSizedThreads) {
    const int i = sh.list[e / kGroup];
    const long long k = i / per_class;
    sh.pairs[e] = bucket(cnt, total, k * row_stride + (i - k * per_class) * kGroup + e % kGroup);
  }
  for (int e = threadIdx.x; e < 2 * kSizedMaxClasses * kSizedWarps; e += kSizedThreads) {
    (&sh.part[0][0][0])[e] = 0.0;
  }
  if (threadIdx.x < classes) sh.sk[threadIdx.x] = s_mine;
  if (threadIdx.x == 0) {
    sh.lo = lo0;
    sh.hi = hi0;
    sh.t = lo0;
    sh.n_groups = n_groups;
    if (tally != nullptr) {
      atomicAdd(tally + (n_groups <= kSizedWarps ? 0 : 1), 1);
      atomicAdd(tally + 2 + min(n_groups, kTallyBins - 1), 1);
    }
  }
  __syncthreads();
  if (n_groups <= kSizedWarps) {  // the few-groups plan: no block barrier from here
    const int warps = max(max(n_groups, classes), 1);
    if (warp < warps) {
      const float t = sized_few_groups(sh, per_class, classes, cap, sh.lo, sh.hi, iters,
                                       32 * warps);
      if (threadIdx.x == 0) *t_out = t;
    }
    return;
  }
  for (int it = 0; it < iters; ++it) {
    const float t = sh.t;
    // 1. the groups, a warp at a time, in order within the warp
    double acc_m = 0.0, acc_i = 0.0;
    int cls = -1;
    for (int g = warp; g < n_groups; g += kSizedWarps) {
      const int i = g < kCacheGroups ? sh.list[g] : __ldcg(groups + g);
      const int k = (int)(i / per_class);
      if (k != cls) {
        if (cls >= 0 && lane == 0) {
          sh.part[0][cls][warp] = acc_m;
          sh.part[1][cls][warp] = acc_i;
        }
        cls = k;
        acc_m = acc_i = 0.0;
      }
      const float tk = __fmul_rn(__ldg(s + k), t);
      double m2 = 0.0, i2 = 0.0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int leaf = lane + 32 * h;
        float2 b;
        if (g < kCacheGroups) {
          b = sh.pairs[g * kGroup + leaf];
        } else {
          b = bucket(cnt, total, (long long)k * row_stride + (i - (long long)k * per_class) *
                                                                 kGroup + leaf);
        }
        const float z = fminf(fmaxf(__fsub_rn(b.y, tk), 0.0f), 1.0f);
        m2 = __dadd_rn(m2, (double)__fmul_rn(b.x, z));
        i2 = __dadd_rn(i2, z > 0.0f && z < 1.0f ? (double)b.x : 0.0);
      }
      for (int o = 16; o > 0; o >>= 1) {
        m2 = __dadd_rn(m2, __shfl_xor_sync(0xffffffffu, m2, o));
        i2 = __dadd_rn(i2, __shfl_xor_sync(0xffffffffu, i2, o));
      }
      acc_m = __dadd_rn(acc_m, m2);
      acc_i = __dadd_rn(acc_i, i2);
    }
    if (cls >= 0 && lane == 0) {
      sh.part[0][cls][warp] = acc_m;
      sh.part[1][cls][warp] = acc_i;
    }
    __syncthreads();
    // 2. a warp a class and sum; thread 0 the step
    if (warp < classes) {
      double m = sh.part[0][warp][lane], n_in = sh.part[1][warp][lane];
      sh.part[0][warp][lane] = 0.0;
      sh.part[1][warp][lane] = 0.0;
      for (int o = 16; o > 0; o >>= 1) {
        m = __dadd_rn(m, __shfl_xor_sync(0xffffffffu, m, o));
        n_in = __dadd_rn(n_in, __shfl_xor_sync(0xffffffffu, n_in, o));
      }
      if (lane == 0) {
        sh.part[0][warp][0] = m;  // read by thread 0 after the warps of the classes
        sh.part[1][warp][0] = n_in;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double mass = 0.0, slope = 0.0;
      for (int k = 0; k < classes; ++k) {
        const float sk = __ldg(s + k);
        mass = __dadd_rn(mass, __dmul_rn((double)sk, sh.part[0][k][0]));
        slope = __dadd_rn(slope, __dmul_rn((double)__fmul_rn(sk, sk), sh.part[1][k][0]));
        sh.part[0][k][0] = 0.0;
        sh.part[1][k][0] = 0.0;
      }
      const float m32 = __double2float_rn(mass), s32 = __double2float_rn(slope);
      float lo = sh.lo, hi = sh.hi;
      const bool too_much = m32 >= cap;
      lo = too_much ? t : lo;
      hi = too_much ? hi : t;
      const float t_newton = __fadd_rn(t, __fdiv_rn(__fsub_rn(m32, cap), fmaxf(s32, 1e-12f)));
      const float t_mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      const bool ok = s32 > 0.0f && t_newton > lo && t_newton < hi;
      sh.lo = lo;
      sh.hi = hi;
      sh.t = ok ? t_newton : t_mid;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *t_out = sh.t;
}

}  // namespace

// cnt and total: `classes` stacked trees, row_stride nodes apart, each with
// v leaves (a multiple of 64) and, right after them, the level of the sums
// of each 64 (a radix-64 tree).  s: (classes,) float32 class sizes; cap, lo,
// hi: () float32.  groups: scratch of classes * v / 64 int32.  t_out: ()
// float32, the last iterate.  tally: null, or 2 + kTallyBins int32 counters:
// the launches of the few-groups and the block plan, then the launches by G
// (the last bin G >= kTallyBins - 1).
extern "C" int repro_solve_sized(const void* cnt, const void* total, long long row_stride,
                                 long long v, int classes, const void* s, const void* cap,
                                 const void* lo, const void* hi, int iters, void* groups,
                                 void* t_out, void* tally, void* stream) {
  if (classes < 1 || classes > kSizedMaxClasses || v < kGroup || v % kGroup || iters < 0 ||
      row_stride < v + v / kGroup || (long long)classes * (v / kGroup) > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(SizedShared);
  const cudaError_t e = cudaFuncSetAttribute(
      solve_sized_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  solve_sized_kernel<<<1, kSizedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cnt), static_cast<const float*>(total), row_stride, v, classes,
      static_cast<const float*>(s), static_cast<const float*>(cap), static_cast<const float*>(lo),
      static_cast<const float*>(hi), iters, static_cast<int*>(groups),
      static_cast<float*>(t_out), static_cast<int*>(tally));
  return (int)cudaGetLastError();
}
