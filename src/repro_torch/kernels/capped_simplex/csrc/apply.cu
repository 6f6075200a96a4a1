// The projection's last step, elementwise: out_i = clip(f_i + eta * c_i - tau, 0, 1).
//
// Replaces the Pallas TPU kernel src/repro/kernels/capped_simplex/kernel.py
// (apply_kernel, launched by _grid_apply).  eta and tau are 0-d tensors on the
// card, read by pointer, so the caller never waits for them on the host.
// The dense warm path does not launch this kernel: its clip is the epilogue
// of mass.cu's project_warm_kernel, from y in registers.  This one serves the
// bisection projection and fused_ogb_update.
//
// Bound on an H100 (3.35 TB/s): bytes, 12 B per item (read f and c, write
// out): 3.6 us at n = 1e6.  So the design is about keeping bytes in flight:
//   * 16-byte loads and stores over the body where f, c and out share their
//     offset modulo 16 bytes (the wrapper gives out f's offset), with a
//     scalar head before it and a scalar tail after it, in the same kernel;
//     where f and c disagree, every item takes the scalar loop;
//   * kUnroll float4 of f and of c loaded by each thread before any
//     arithmetic, on a grid of kBlocksPerSm blocks an SM, not one item a
//     thread;
//   * eta and tau read once a block (thread 0, shared memory), while the
//     first loads are in flight.
// __fmul_rn/__fadd_rn/__fsub_rn keep nvcc from contracting into an fma, so
// the result is bit for bit the plain PyTorch version's.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kUnroll = 2;  // float4 of f and of c a thread keeps in flight

__device__ __forceinline__ float clip_step(float f, float c, float eta, float tau) {
  const float z = __fsub_rn(__fadd_rn(f, __fmul_rn(eta, c)), tau);
  return fminf(fmaxf(z, 0.0f), 1.0f);
}

// Items [0, head) and [head + 4 * body, n) one at a time; the body as float4.
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ f, const float* __restrict__ c,
             const float* __restrict__ eta_p, const float* __restrict__ tau_p, long long n,
             long long head, long long body, float* __restrict__ out) {
  __shared__ float scalars[2];
  if (threadIdx.x == 0) {
    scalars[0] = *eta_p;
    scalars[1] = *tau_p;
  }
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const float4* f4 = reinterpret_cast<const float4*>(f + head);
  const float4* c4 = reinterpret_cast<const float4*>(c + head);
  float4* o4 = reinterpret_cast<float4*>(out + head);
  float4 a[kUnroll], b[kUnroll];
  long long v = first;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (v + u * stride < body) {
      a[u] = __ldg(f4 + v + u * stride);
      b[u] = __ldg(c4 + v + u * stride);
    }
  }
  __syncthreads();
  const float eta = scalars[0], tau = scalars[1];
  while (v < body) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = v + u * stride;
      if (j < body) {
        o4[j] = make_float4(
            clip_step(a[u].x, b[u].x, eta, tau), clip_step(a[u].y, b[u].y, eta, tau),
            clip_step(a[u].z, b[u].z, eta, tau), clip_step(a[u].w, b[u].w, eta, tau));
      }
    }
    v += kUnroll * stride;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * stride < body) {
        a[u] = __ldg(f4 + v + u * stride);
        b[u] = __ldg(c4 + v + u * stride);
      }
    }
  }
  for (long long i = first; i < head; i += stride) out[i] = clip_step(f[i], c[i], eta, tau);
  for (long long i = head + 4 * body + first; i < n; i += stride) {
    out[i] = clip_step(f[i], c[i], eta, tau);
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// sms: the card's SMs; the grid is kBlocksPerSm blocks an SM, fewer where n
// needs fewer.
extern "C" int repro_apply(const void* f, const void* c, const void* eta, const void* tau,
                           long long n, void* out, int sms, void* stream) {
  if (n < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  const long long max_blocks = (long long)sms * kBlocksPerSm;
  const std::uintptr_t off = reinterpret_cast<std::uintptr_t>(f) & 15;
  long long head = n, body = 0;
  if ((reinterpret_cast<std::uintptr_t>(c) & 15) == off &&
      (reinterpret_cast<std::uintptr_t>(out) & 15) == off) {
    head = (long long)((16 - off) & 15) / 4;
    head = head < n ? head : n;
    body = (n - head) / 4;
  }
  const long long scalar = n - 4 * body;
  const long long work = cdiv(body, kUnroll) > scalar ? cdiv(body, kUnroll) : scalar;
  const long long want = cdiv(work, kThreads);
  const unsigned blocks = (unsigned)(want < max_blocks ? (want > 0 ? want : 1) : max_blocks);
  apply_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(c),
      static_cast<const float*>(eta), static_cast<const float*>(tau), n, head, body,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
