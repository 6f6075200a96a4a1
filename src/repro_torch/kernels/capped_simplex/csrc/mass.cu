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
// repro_project_warm: the warm projection's whole solve in one launch.
// capped_simplex_project_warm runs `sweeps` safeguarded Newton steps, each
// a K = 1 mass pass and a few scalar updates.  As two launches a sweep and
// about 12 0-d PyTorch ops, that is ~70 launches enqueued one by one, and the
// catalog is read once a sweep.  Here:
//   * one persistent cooperative launch, one block of kWarmThreads per
//     resident slot (one a SM); a barrier across the grid ends each sweep
//     (../../csrc/persistent.cuh);
//   * y = f + eta * c is formed once and kept in registers, kWarmItems a
//     thread (4 MB at n = 1e6 on 132 SMs); past that the sweeps re-read f and
//     c through a grid-stride loop (from the 50 MB L2 up to n ~ 6e6);
//   * each sweep reduces the mass (in double from the first add) and the
//     interior count per thread, by warp butterflies and per block; a block's
//     partial goes to its slot of the (sweeps, G) partials; after the barrier
//     a warp of every block sums the G partials in one fixed order, all its
//     loads in flight at once (a sweep is latency-bound), takes the Newton
//     step and hands tau to its block, so every block holds the same tau,
//     with no second barrier and no host round trip;
//   * the scalar step takes the plain version's float32 roundings
//     (__fsub_rn, __fdiv_rn, __fadd_rn, 0.5f * __fadd_rn(lo, hi)) and its
//     safeguard, which accepts an end of the bracket.
// Fixed-order sums and integer counts: two runs give the same tau, bit for
// bit.
// Bound of the whole solve on an H100: f and c read once, 8 B an item
// (2.39 us at n = 1e6), against 9 operations an item a sweep (5 sweeps:
// 0.67 us at 67 TFLOP/s): bytes.
//
// The epilogue: given an output `out`, the kernel also writes the
// projection's f' = clip(y - tau, 0, 1) at the final tau, which every block
// already holds after the last sweep, so it needs no further barrier.  In
// the resident plan y comes from registers and f and c are not read again;
// the streaming plan reads them once more.  The roundings are apply.cu's, so
// f' is bit for bit apply's at that tau; the solve itself is the same with
// or without it.  With out == nullptr (project_warm_tau) it writes tau only.
// Bound with the epilogue: f and c read once and f' written, 12 B an item
// (3.58 us at n = 1e6).

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
// The warm projection in one persistent launch.

namespace {

constexpr int kWarmThreads = 1024;
constexpr int kWarmWarps = kWarmThreads / 32;
constexpr int kWarmBlocksPerSm = 1;
constexpr int kWarmItems = 8;   // items of y a thread keeps in registers
constexpr int kWarmUnroll = 8;  // partials a lane loads at once: 32 * 8 >= 132 blocks

__device__ __forceinline__ void add_term(float y, float t, double& m, unsigned& q) {
  const float z = __fsub_rn(y, t);
  m += (double)fminf(fmaxf(z, 0.0f), 1.0f);
  q += (z > 0.0f && z < 1.0f) ? 1u : 0u;
}

template <bool kResident>
__global__ void __launch_bounds__(kWarmThreads, kWarmBlocksPerSm)
project_warm_kernel(const float* __restrict__ f, const float* __restrict__ c,
                    const float* __restrict__ eta_p, const float* __restrict__ cap_p,
                    const float* __restrict__ lo_p, const float* __restrict__ hi_p,
                    const float* __restrict__ tau0_p, long long n, int sweeps,
                    double* __restrict__ pmass, unsigned* __restrict__ pcnt,
                    float* __restrict__ tau_out, float* __restrict__ out) {
  __shared__ double sm[kWarmWarps];
  __shared__ unsigned sq[kWarmWarps];
  __shared__ float next_t;
  const float eta = *eta_p, cap = *cap_p;
  float lo = *lo_p, hi = *hi_p;
  float t = fminf(fmaxf(*tau0_p, lo), hi);
  const int blocks = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = (long long)blocks * kWarmThreads;
  const long long first = (long long)blockIdx.x * kWarmThreads + threadIdx.x;
  float y[kResident ? kWarmItems : 1];
  if constexpr (kResident) {
#pragma unroll
    for (int j = 0; j < kWarmItems; ++j) {
      const long long i = first + j * stride;
      // past n: -inf adds nothing to the mass and is never interior
      y[j] = i < n ? __fadd_rn(f[i], __fmul_rn(eta, c[i])) : __int_as_float(0xff800000);
    }
  }
  for (int s = 0; s < sweeps; ++s) {
    double m = 0.0;
    unsigned q = 0u;
    if constexpr (kResident) {
#pragma unroll
      for (int j = 0; j < kWarmItems; ++j) add_term(y[j], t, m, q);
    } else {
      for (long long i = first; i < n; i += stride) {
        add_term(__fadd_rn(f[i], __fmul_rn(eta, c[i])), t, m, q);
      }
    }
    // the block's partial: warps by butterflies, then warp 0 over the warps
    m = persistent::warp_sum(m);
    q = persistent::warp_sum(q);
    if (lane == 0) {
      sm[warp] = m;
      sq[warp] = q;
    }
    __syncthreads();
    double* pm = pmass + (long long)s * blocks;
    unsigned* pq = pcnt + (long long)s * blocks;
    if (warp == 0) {
      m = persistent::warp_sum(lane < kWarmWarps ? sm[lane] : 0.0);
      q = persistent::warp_sum(lane < kWarmWarps ? sq[lane] : 0u);
      if (lane == 0) {
        pm[blockIdx.x] = m;
        pq[blockIdx.x] = q;
      }
    }
    persistent::grid_barrier();
    // warp 0 sums the G partials in one fixed order, every load in flight
    // at once, takes the Newton step and hands the next tau to the block
    if (warp == 0) {
      m = 0.0;
      q = 0u;
      for (int b0 = lane; b0 < blocks; b0 += 32 * kWarmUnroll) {
        double vm[kWarmUnroll];
        unsigned vq[kWarmUnroll];
#pragma unroll
        for (int u = 0; u < kWarmUnroll; ++u) {
          const int b = b0 + 32 * u;
          vm[u] = b < blocks ? __ldcg(pm + b) : 0.0;
          vq[u] = b < blocks ? __ldcg(pq + b) : 0u;
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
      const float mass = (float)m, cnt = (float)q;
      if (mass >= cap) {
        lo = t;
      } else {
        hi = t;
      }
      const float t_newton = __fadd_rn(t, __fdiv_rn(__fsub_rn(mass, cap), fmaxf(cnt, 1.0f)));
      const float t_mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      if (lane == 0) next_t = (cnt > 0.0f && t_newton >= lo && t_newton <= hi) ? t_newton : t_mid;
    }
    __syncthreads();
    // next_t is written again only past the next barrier
    t = next_t;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *tau_out = t;
  if (out == nullptr) return;
  if constexpr (kResident) {
#pragma unroll
    for (int j = 0; j < kWarmItems; ++j) {
      const long long i = first + j * stride;
      if (i < n) out[i] = fminf(fmaxf(__fsub_rn(y[j], t), 0.0f), 1.0f);
    }
  } else {
    for (long long i = first; i < n; i += stride) {
      const float z = __fsub_rn(__fadd_rn(f[i], __fmul_rn(eta, c[i])), t);
      out[i] = fminf(fmaxf(z, 0.0f), 1.0f);
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

// pmass (double) and pcnt hold sweeps * blocks partials; the wrapper
// allocates them.  resident: y in registers, which needs
// n <= blocks * kWarmThreads * kWarmItems.  out: n floats for f', or null
// for tau alone.
extern "C" int repro_project_warm(const void* f, const void* c, const void* eta, const void* cap,
                                  const void* lo, const void* hi, const void* tau0, long long n,
                                  int sweeps, int blocks, int resident, void* pmass, void* pcnt,
                                  void* tau, void* out, void* stream) {
  if (blocks < 1 || sweeps < 0 ||
      (resident && n > (long long)blocks * kWarmThreads * kWarmItems)) {
    return (int)cudaErrorInvalidValue;
  }
  void* args[] = {&f, &c, &eta, &cap, &lo, &hi, &tau0, &n, &sweeps, &pmass, &pcnt, &tau, &out};
  return persistent::launch(warm_kernel(resident), blocks, kWarmThreads, args,
                            static_cast<cudaStream_t>(stream));
}
