// Capped-simplex mass and interior count at K thresholds, one catalog pass:
//
//   y_i      = f_i + eta * c_i
//   mass[k]  = sum_i clip(y_i - tau_k, 0, 1)
//   cnt[k]   = #{i : 0 < y_i - tau_k < 1}
//
// Replaces the Pallas TPU kernel src/repro/kernels/capped_simplex/kernel.py
// (mass_kernel, launched by _grid_masses).  That kernel carries its sums from
// one grid step to the next in the output block, which works because a TPU
// runs the grid in order.  Hopper runs blocks in no order, so this is a
// two-level reduction without float atomics, and tau comes out the same on
// every run:
//   1. mass_partials_kernel: grid (G, ceil(K / 8)); each thread walks the
//      catalog with a grid stride, computes y once per item and accumulates
//      8 thresholds in registers; the block reduces by warp shuffles and
//      writes one partial mass (float) and one partial count (unsigned) per
//      threshold.
//   2. mass_finish_kernel: one block per threshold sums the G partials in a
//      fixed order (the mass in double) and writes mass[k] and cnt[k].
// Counts are integers all the way, so they are exact.  It works for any
// K >= 1 and any n (the ragged tail is masked by the stride loop); the
// Pallas kernel needs K to be a multiple of 8.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s float32): at K = 1 bytes, 8 B per
// item (2.4 us at n = 1e6); at K = 64 operations, 2 + 7K per item (6.7 us).
// y is computed with __fmul_rn/__fadd_rn so that nvcc does not contract it
// into an fma: the plain PyTorch version rounds twice, and so does this.
//
// repro_project_warm: the warm projection's whole solve in one launch, for
// one row or for R rows at once (a sweep's grid of combos: R fractional
// states f over one shared histogram c, each row with its own eta,
// capacity, bracket and seed; or a fleet's tenants: R states f, each over
// its own row of c, the rows `c_stride` floats apart, 0 for a shared c).
// capped_simplex_project_warm runs `sweeps` safeguarded Newton steps, each
// a K = 1 mass pass and a few scalar updates.  As two launches a sweep and
// about 12 0-d PyTorch ops, that is ~70 launches enqueued one by one, and
// the catalog is read once a sweep.  Here:
//   * one persistent cooperative launch; a barrier across the grid ends each
//     sweep (../../csrc/persistent.cuh), every row's sweep in lock-step;
//   * each row is cut into fixed tiles of kTile = kWarmThreads * kWarmItems
//     items, and a tile's partial is summed in one fixed order: thread x of
//     the tile takes items x, x + kWarmThreads, ... (in double from the
//     first add), then warp butterflies, then a warp's butterflies over the
//     warps' partials in shared memory (a block's tiles go with no barrier
//     between them, one barrier a sweep).  Each tile's partial goes to its
//     own slot of the (sweeps, rows, tiles) partials, and each row's tiles
//     are summed in tile order after the grid barrier.  So a row's mass, count and tau do not depend on the grid, on
//     R or on the plan below: a row of a sweep has the bits of its own run;
//   * a block takes a contiguous run of k of the R * tiles tiles, in rounds
//     of 64 (a block barrier between rounds; one round unless one row's
//     tiles outgrow 64 a block).  The wrapper gives a launch as many rows
//     as keep k <= 64 and launches each group of rows in turn, so any R
//     and any n run, each row with its bits.  In
//     the resident plan (R * tiles <= the resident blocks) k = 1 and y = f +
//     eta * c is formed once and kept in registers, kWarmItems a thread
//     (4 MB at n = 1e6 on 132 SMs); past that the streaming plan re-reads f
//     and c every sweep (R * n + n floats, through L2 while they fit its
//     50 MB; at R = 18, n = 1e6 the f's alone are 72 MB);
//   * after the barrier, a warp of the block for each row its tiles touch
//     sums that row's tile partials, all its loads in flight at once (a
//     sweep is latency-bound), and takes the Newton step; every block that
//     touches a row reads the same partials in the same order and so holds
//     the same tau, with no second barrier and no host round trip;
//   * the scalar step takes the plain version's float32 roundings
//     (__fsub_rn, __fdiv_rn, __fadd_rn, 0.5f * __fadd_rn(lo, hi)) and its
//     safeguard, which accepts an end of the bracket.
// Fixed-order sums and integer counts: two runs give the same tau, bit for
// bit, and each row of R the tau of its run alone.
// Bound of the whole solve on an H100: each f and c read once, 4 (R + 1) B
// an item (2.39 us at R = 1, n = 1e6), against 9 operations an item a row
// a sweep (5 sweeps: 0.67 us a row at 67 TFLOP/s): bytes.  The streaming
// plan moves (sweeps + 1) * 4 (R + 1) B an item (it re-reads f and c every
// sweep and in its epilogue): 136 us of HBM at R = 18, n = 1e6, sweeps = 5,
// where they do not stay in L2.
//
// The epilogue: given an output `out`, the kernel also writes each row's
// f' = clip(y - tau, 0, 1) at its final tau, which every block that holds
// the row already has after the last sweep, so it needs no further
// barrier.  In the resident plan y comes from registers and f and c are
// not read again; the streaming plan reads them once more.  The roundings
// are apply.cu's, so f' is bit for bit apply's at that tau; the solve
// itself is the same with or without it.  With out == nullptr
// (project_warm_tau) it writes tau only.
// Bound with the epilogue: f and c read once and f' written, 4 (2R + 1) B
// an item (3.58 us at R = 1, n = 1e6).

#include <cstdint>

#include <cuda_runtime.h>

#include "../../csrc/persistent.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTauChunk = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
mass_partials_kernel(const float* __restrict__ f, const float* __restrict__ c,
                     const float* __restrict__ eta_p, const float* __restrict__ taus,
                     int k, long long n, float* __restrict__ pmass,
                     unsigned* __restrict__ pcnt) {
  const int k0 = blockIdx.y * kTauChunk;
  const int nk = min(kTauChunk, k - k0);
  const float eta = *eta_p;
  float t[kTauChunk], m[kTauChunk];
  unsigned q[kTauChunk];
#pragma unroll
  for (int j = 0; j < kTauChunk; ++j) {
    t[j] = j < nk ? taus[k0 + j] : 0.0f;
    m[j] = 0.0f;
    q[j] = 0u;
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const float y = __fadd_rn(f[i], __fmul_rn(eta, c[i]));
#pragma unroll
    for (int j = 0; j < kTauChunk; ++j) {
      if (j < nk) {
        const float z = __fsub_rn(y, t[j]);
        m[j] += fminf(fmaxf(z, 0.0f), 1.0f);
        q[j] += (z > 0.0f && z < 1.0f) ? 1u : 0u;
      }
    }
  }
  __shared__ float sm[kTauChunk][kWarps];
  __shared__ unsigned sq[kTauChunk][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kTauChunk; ++j) {
    const float ms = warp_sum(m[j]);
    const unsigned qs = warp_sum(q[j]);
    if (lane == 0) {
      sm[j][warp] = ms;
      sq[j][warp] = qs;
    }
  }
  __syncthreads();
  if (threadIdx.x < nk) {
    const int j = threadIdx.x;
    float ms = 0.0f;
    unsigned qs = 0u;
    for (int w = 0; w < kWarps; ++w) {
      ms += sm[j][w];
      qs += sq[j][w];
    }
    pmass[(long long)(k0 + j) * gridDim.x + blockIdx.x] = ms;
    pcnt[(long long)(k0 + j) * gridDim.x + blockIdx.x] = qs;
  }
}

__global__ void __launch_bounds__(kThreads)
mass_finish_kernel(const float* __restrict__ pmass, const unsigned* __restrict__ pcnt,
                   int blocks, float* __restrict__ mass, float* __restrict__ cnt) {
  const int k = blockIdx.x;
  double ms = 0.0;
  unsigned long long qs = 0ull;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    ms += (double)pmass[(long long)k * blocks + b];
    qs += pcnt[(long long)k * blocks + b];
  }
  __shared__ double sm[kThreads];
  __shared__ unsigned long long sq[kThreads];
  sm[threadIdx.x] = ms;
  sq[threadIdx.x] = qs;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      sm[threadIdx.x] += sm[threadIdx.x + h];
      sq[threadIdx.x] += sq[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    mass[k] = (float)sm[0];
    cnt[k] = (float)sq[0];
  }
}

}  // namespace

// pmass and pcnt hold k * blocks partials each; the wrapper allocates them.
extern "C" int repro_masses(const void* f, const void* c, const void* eta, const void* taus,
                            int k, long long n, int blocks, void* pmass, void* pcnt,
                            void* mass, void* cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks, (unsigned)((k + kTauChunk - 1) / kTauChunk));
  mass_partials_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(f), static_cast<const float*>(c),
      static_cast<const float*>(eta), static_cast<const float*>(taus), k, n,
      static_cast<float*>(pmass), static_cast<unsigned*>(pcnt));
  mass_finish_kernel<<<(unsigned)k, kThreads, 0, s>>>(
      static_cast<const float*>(pmass), static_cast<const unsigned*>(pcnt), blocks,
      static_cast<float*>(mass), static_cast<float*>(cnt));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The warm projection in one persistent launch, over R rows.

namespace {

constexpr int kWarmThreads = 1024;
constexpr int kWarmWarps = kWarmThreads / 32;
constexpr int kWarmBlocksPerSm = 1;
constexpr int kWarmItems = 8;   // items of y a thread keeps in registers
constexpr int kWarmTile = kWarmThreads * kWarmItems;  // items of a row's tile
constexpr int kWarmUnroll = 8;  // partials a lane loads at once: 32 * 8 tiles a round
constexpr int kWarmRowsPerBlock = 64;  // the most rows one block's tiles touch
constexpr int kWarmTilesPerBlock = 64;  // the tiles of a block's round of partials

struct WarmArgs {
  const float* f;      // (rows, n)
  const float* c;      // (n,) shared by the rows (c_stride 0), or a row each
  long long c_stride;  // floats between the rows of c: 0 or n
  const float* eta;    // (rows,) each of these
  const float* cap;
  const float* lo;
  const float* hi;
  const float* tau0;
  long long n;
  int rows;
  int sweeps;
  int tiles;           // tiles a row: ceil(n / kWarmTile)
  int per_block;       // tiles a block (a contiguous run)
  double* pmass;       // (sweeps, rows, tiles)
  unsigned* pcnt;
  float* tau;          // (rows,)
  float* out;          // (rows, n), or null
};

__device__ __forceinline__ void add_term(float y, float t, double& m, unsigned& q) {
  const float z = __fsub_rn(y, t);
  m += (double)fminf(fmaxf(z, 0.0f), 1.0f);
  q += (z > 0.0f && z < 1.0f) ? 1u : 0u;
}

__device__ __forceinline__ float form_y(const WarmArgs& a, long long row, long long i,
                                        float eta) {
  return __fadd_rn(a.f[row * a.n + i], __fmul_rn(eta, a.c[row * a.c_stride + i]));
}

template <bool kResident>
__global__ void __launch_bounds__(kWarmThreads, kWarmBlocksPerSm)
project_warm_kernel(WarmArgs a) {
  // each (tile, warp) partial of a sweep, then each tile's over the warps
  __shared__ double s_pm[kWarmTilesPerBlock][kWarmWarps];
  __shared__ unsigned s_pq[kWarmTilesPerBlock][kWarmWarps];
  // the Newton state of each row this block's tiles touch
  __shared__ float s_lo[kWarmRowsPerBlock], s_hi[kWarmRowsPerBlock], s_t[kWarmRowsPerBlock];
  __shared__ float s_eta[kWarmRowsPerBlock], s_cap[kWarmRowsPerBlock];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the block's tiles first_tile .. end_tile - 1, from tile lt0 of row row0
  // (32-bit: the host keeps rows * tiles below 2^31, and no division is
  // left in the sweeps)
  const int total = a.rows * a.tiles;
  const int first_tile = blockIdx.x * a.per_block;
  const int end_tile = min(first_tile + a.per_block, total);
  const int ntiles = max(end_tile - first_tile, 0);
  const int row0 = first_tile < total ? first_tile / a.tiles : 0;
  const int lt0 = first_tile - row0 * a.tiles;
  const int nrows = ntiles > 0 ? (end_tile - 1) / a.tiles - row0 + 1 : 0;
  // the resident plan's one tile, y in registers: its loads go out first,
  // beside the rows' scalars (a thread a row: nrows <= kWarmRowsPerBlock)
  const bool holds_row = threadIdx.x < nrows;
  float lo = 0.0f, hi = 0.0f, t0 = 0.0f, eta_r = 0.0f, cap_r = 0.0f;
  if (holds_row) {
    lo = a.lo[row0 + threadIdx.x];
    hi = a.hi[row0 + threadIdx.x];
    t0 = a.tau0[row0 + threadIdx.x];
    eta_r = a.eta[row0 + threadIdx.x];
    cap_r = a.cap[row0 + threadIdx.x];
  }
  float y[kResident ? kWarmItems : 1];
  if constexpr (kResident) {
    if (ntiles > 0) {
      const long long base = (long long)lt0 * kWarmTile + threadIdx.x;
      const float eta = a.eta[row0];
#pragma unroll
      for (int j = 0; j < kWarmItems; ++j) {
        const long long i = base + (long long)j * kWarmThreads;
        // past n: -inf adds nothing to the mass and is never interior
        y[j] = i < a.n ? form_y(a, row0, i, eta) : __int_as_float(0xff800000);
      }
    }
  }
  if (holds_row) {
    s_lo[threadIdx.x] = lo;
    s_hi[threadIdx.x] = hi;
    s_t[threadIdx.x] = fminf(fmaxf(t0, lo), hi);
    s_eta[threadIdx.x] = eta_r;
    s_cap[threadIdx.x] = cap_r;
  }
  __syncthreads();
  for (int s = 0; s < a.sweeps; ++s) {
    double* pm = a.pmass + (long long)s * total;
    unsigned* pq = a.pcnt + (long long)s * total;
    // the block's tiles in rounds of kWarmTilesPerBlock (one round unless a
    // row alone outgrows the grid's blocks)
    for (int k0 = 0, row = row0, lt = lt0; k0 < ntiles; k0 += kWarmTilesPerBlock) {
      const int kn = min(ntiles - k0, kWarmTilesPerBlock);
      if (k0 > 0) __syncthreads();  // the round before has read its partials
      // every tile's warp partials, with no barrier between tiles: thread x
      // of a tile takes its items x, x + kWarmThreads, ... in order, a warp
      // adds its lanes by butterflies
      for (int k = 0; k < kn; ++k) {
        const float t = s_t[row - row0];
        double m = 0.0;
        unsigned q = 0u;
        if constexpr (kResident) {
#pragma unroll
          for (int j = 0; j < kWarmItems; ++j) add_term(y[j], t, m, q);
        } else {
          const long long base = (long long)lt * kWarmTile + threadIdx.x;
          const float eta = s_eta[row - row0];
#pragma unroll
          for (int j = 0; j < kWarmItems; ++j) {
            const long long i = base + (long long)j * kWarmThreads;
            if (i < a.n) add_term(form_y(a, row, i, eta), t, m, q);
          }
        }
        if (++lt == a.tiles) {
          lt = 0;
          ++row;
        }
        m = persistent::warp_sum(m);
        q = persistent::warp_sum(q);
        if (lane == 0) {
          s_pm[k][warp] = m;
          s_pq[k][warp] = q;
        }
      }
      __syncthreads();
      // a warp a tile: its warps' partials in warp order, to the tile's slot
      for (int k = warp; k < kn; k += kWarmWarps) {
        const double m = persistent::warp_sum(s_pm[k][lane]);
        const unsigned q = persistent::warp_sum(s_pq[k][lane]);
        if (lane == 0) {
          pm[first_tile + k0 + k] = m;
          pq[first_tile + k0 + k] = q;
        }
      }
    }
    persistent::grid_barrier();
    // a warp a row: its tiles' partials in tile order, every load in
    // flight at once, then the Newton step
    for (int r = warp; r < nrows; r += kWarmWarps) {
      const long long at = (long long)(row0 + r) * a.tiles;
      double m = 0.0;
      unsigned q = 0u;
      for (int b0 = lane; b0 < a.tiles; b0 += 32 * kWarmUnroll) {
        double vm[kWarmUnroll];
        unsigned vq[kWarmUnroll];
#pragma unroll
        for (int u = 0; u < kWarmUnroll; ++u) {
          const int b = b0 + 32 * u;
          vm[u] = b < a.tiles ? __ldcg(pm + at + b) : 0.0;
          vq[u] = b < a.tiles ? __ldcg(pq + at + b) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kWarmUnroll; ++u) {
          m += vm[u];
          q += vq[u];
        }
      }
      m = persistent::warp_sum(m);
      q = persistent::warp_sum(q);
      // the safeguarded Newton step, rounded as the plain version's 0-d ops
      const float mass = (float)m, cnt = (float)q, cap = s_cap[r];
      const float t = s_t[r];
      float lo = s_lo[r], hi = s_hi[r];
      if (mass >= cap) {
        lo = t;
      } else {
        hi = t;
      }
      const float t_newton = __fadd_rn(t, __fdiv_rn(__fsub_rn(mass, cap), fmaxf(cnt, 1.0f)));
      const float t_mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      __syncwarp();
      if (lane == 0) {
        s_lo[r] = lo;
        s_hi[r] = hi;
        s_t[r] = (cnt > 0.0f && t_newton >= lo && t_newton <= hi) ? t_newton : t_mid;
      }
    }
    __syncthreads();
  }
  // the row's tau, from the block that holds its first tile
  for (int r = threadIdx.x; r < nrows; r += kWarmThreads) {
    const int head = (row0 + r) * a.tiles;
    if (head >= first_tile && head < end_tile) a.tau[row0 + r] = s_t[r];
  }
  if (a.out == nullptr) return;
  if constexpr (kResident) {
    if (ntiles > 0) {
      const long long base = (long long)lt0 * kWarmTile + threadIdx.x;
      const float t = s_t[0];
#pragma unroll
      for (int j = 0; j < kWarmItems; ++j) {
        const long long i = base + (long long)j * kWarmThreads;
        if (i < a.n) a.out[row0 * a.n + i] = fminf(fmaxf(__fsub_rn(y[j], t), 0.0f), 1.0f);
      }
    }
  } else {
    for (int k = 0, row = row0, lt = lt0; k < ntiles; ++k) {
      const long long base = (long long)lt * kWarmTile + threadIdx.x;
      const float t = s_t[row - row0], eta = s_eta[row - row0];
#pragma unroll
      for (int j = 0; j < kWarmItems; ++j) {
        const long long i = base + (long long)j * kWarmThreads;
        if (i < a.n) {
          const float z = __fsub_rn(form_y(a, row, i, eta), t);
          a.out[row * a.n + i] = fminf(fmaxf(z, 0.0f), 1.0f);
        }
      }
      if (++lt == a.tiles) {
        lt = 0;
        ++row;
      }
    }
  }
}

const void* warm_kernel(int resident) {
  return resident ? (const void*)project_warm_kernel<true>
                  : (const void*)project_warm_kernel<false>;
}

}  // namespace

// Blocks of the warm projection that one SM holds at once.
extern "C" int repro_project_warm_occupancy(int resident, int* blocks_per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, warm_kernel(resident),
                                                            kWarmThreads, 0);
}

// f: (rows, n) float32, c: (n,) with c_stride 0, or (rows, n) with c_stride
// n (a row of counts a row of f); eta, cap, lo, hi, tau0: (rows,) each.
// tiles = ceil(n / kWarmTile) a row and per_block tiles a block, over
// `blocks` blocks that cover rows * tiles; resident needs per_block == 1
// (y in registers).  pmass (double) and pcnt hold sweeps * rows * tiles
// partials; the wrapper allocates them.  tau: (rows,); out: (rows, n) for
// f', or null for tau alone.
extern "C" int repro_project_warm(const void* f, const void* c, long long c_stride,
                                  const void* eta, const void* cap, const void* lo, const void* hi,
                                  const void* tau0, long long n, int rows, int sweeps, int blocks,
                                  int per_block, int resident, void* pmass, void* pcnt, void* tau,
                                  void* out, void* stream) {
  const long long tiles = (n + kWarmTile - 1) / kWarmTile;
  if (n < 1 || rows < 1 || blocks < 1 || per_block < 1 || sweeps < 0 ||
      (c_stride != 0 && c_stride != n) ||
      rows * tiles + per_block > INT32_MAX ||
      (long long)blocks * per_block < rows * tiles ||
      (long long)(blocks - 1) * per_block >= rows * tiles || (resident && per_block != 1) ||
      (per_block + tiles - 2) / tiles + 1 > kWarmRowsPerBlock) {
    return (int)cudaErrorInvalidValue;
  }
  WarmArgs a{static_cast<const float*>(f), static_cast<const float*>(c), c_stride,
             static_cast<const float*>(eta), static_cast<const float*>(cap),
             static_cast<const float*>(lo), static_cast<const float*>(hi),
             static_cast<const float*>(tau0), n, rows, sweeps, (int)tiles, per_block,
             static_cast<double*>(pmass), static_cast<unsigned*>(pcnt),
             static_cast<float*>(tau), static_cast<float*>(out)};
  void* args[] = {&a};
  return persistent::launch(warm_kernel(resident), blocks, kWarmThreads, args,
                            static_cast<cudaStream_t>(stream));
}
