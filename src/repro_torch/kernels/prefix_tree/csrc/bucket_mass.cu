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

#include <cuda_runtime.h>

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
