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

#include <cuda_runtime.h>

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
