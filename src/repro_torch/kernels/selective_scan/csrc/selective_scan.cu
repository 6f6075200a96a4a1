// The selective scan of a Mamba layer (Jamba's), a whole sequence in one launch.
// Per (sequence b, channel d), with the state h of n floats:
//
//   h_t[k] = exp(dt_t[d] * A[d][k]) * h_{t-1}[k] + (dt_t[d] * x_t[d]) * B_t[k]
//   y_t[d] = sum_k h_t[k] * C_t[k] + D[d] * x_t[d]
//
// Replaces no Pallas kernel: the reference scans the recurrence with lax.scan
// (src/repro/models/mamba.py:77, inside mamba_forward) over the decay and drive
// tensors it forms first, (B, S, d_in, n) float32 each.  Prefill runs it over a
// prompt from a zero state, decode over one token from the cache's state; both
// read the state from the (B, d_in, n) tensor they are given and write the
// final state back into it.  x, dt and y are float32 (B, S, d_in) (dt already
// through softplus), A float32 (d_in, n) (-exp(A_log)), B and C float32
// (B, S, n), D float32 (d_in,); every tensor starts on a 16-byte boundary
// (the wrapper checks the addresses).  n is 8 or 16.
//
// Bound on an H100: bytes.  x and dt are read and y written once, 12 bytes a
// (b, t, d): at jamba's served layer (B 8, S 2048, d_in 16 384, n 16) 3.22 GB,
// 0.961 ms at 3.35 TB/s; its float32 work, about 6 flops a (b, t, d, n), is
// 2.58e10, 0.385 ms at 67 TFLOP/s.  The 4.29e9 exponentials are a third
// floor the bound does not count: expf issues one MUFU.EX2 each, 16 an SM a
// clock, about 1.0 ms at 1.98 GHz, beside the FP32 instructions of its range
// reduction.
//
// Design (a first, simple one).  A block of 128 threads takes 128 channels of
// one sequence, grid (ceil(d_in / 128), B); a thread owns one channel, its n
// state values and its row of A in registers for the whole sequence.  B_t and
// C_t are the same for every channel of a sequence: the block stages them in
// shared memory kChunk steps at a time (16-byte loads), and each step reads
// them as broadcast float4s.  Loads of x and dt are coalesced across the
// block (neighbouring threads, neighbouring channels), kBatch steps of them
// issued before the batch's arithmetic, so the loads of a batch overlap; y is
// stored the same way.  The kernel never forms the reference's decay and
// drive tensors (17.2 GB each at the served layer).  The arithmetic is the
// reference's, in its order, rounded at every step (the _rn intrinsics keep
// nvcc from contracting into fmas): dec = expf(dt * A), drv = (dt * x) * B,
// h = dec * h + drv, y summed over k in index order, then y + D * x.  Two runs
// agree bit for bit: no atomics, no order that depends on timing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels a block
constexpr int kChunk = 64;     // steps of B and C staged in shared memory at once
constexpr int kBatch = 8;      // steps of x and dt loaded before their arithmetic

// A row of N floats in shared memory into registers, as N / 4 float4s.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    out[4 * q] = v.x, out[4 * q + 1] = v.y, out[4 * q + 2] = v.z, out[4 * q + 3] = v.w;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ Cm, const float* __restrict__ D,
                          float* __restrict__ state, float* __restrict__ y, int seq, int d_in) {
  static_assert(N % 4 == 0, "a row of B, C, A or the state is whole float4s");
  __shared__ __align__(16) float sb[kChunk * N];
  __shared__ __align__(16) float sc[kChunk * N];
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const bool active = d < d_in;
  float h[N], a[N], dd = 0.0f;
  float* st = state + ((long long)b * d_in + d) * N;
  if (active) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 s4 = reinterpret_cast<const float4*>(st)[q];
      const float4 a4 = reinterpret_cast<const float4*>(A + (long long)d * N)[q];
      h[4 * q] = s4.x, h[4 * q + 1] = s4.y, h[4 * q + 2] = s4.z, h[4 * q + 3] = s4.w;
      a[4 * q] = a4.x, a[4 * q + 1] = a4.y, a[4 * q + 2] = a4.z, a[4 * q + 3] = a4.w;
    }
    dd = D[d];
  }
  const long long first = (long long)b * seq;  // the sequence's first (b, t) row
  const float4* bq = reinterpret_cast<const float4*>(Bm + first * N);
  const float4* cq = reinterpret_cast<const float4*>(Cm + first * N);
  const float* xs = x + first * d_in + d;
  const float* ds = dt + first * d_in + d;
  float* ys = y + first * d_in + d;

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int steps = min(kChunk, seq - t0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int q = threadIdx.x; q < steps * (N / 4); q += kThreads) {
      reinterpret_cast<float4*>(sb)[q] = bq[t0 * (N / 4) + q];
      reinterpret_cast<float4*>(sc)[q] = cq[t0 * (N / 4) + q];
    }
    __syncthreads();
    if (!active) continue;
    for (int s0 = 0; s0 < steps; s0 += kBatch) {
      float xv[kBatch], dv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (s0 + u < steps) {
          const long long at = (long long)(t0 + s0 + u) * d_in;
          xv[u] = xs[at];
          dv[u] = ds[at];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = s0 + u;
        if (s >= steps) break;
        float bk[N], ck[N];
        load_row<N>(sb + s * N, bk);
        load_row<N>(sc + s * N, ck);
        const float dx = __fmul_rn(dv[u], xv[u]);
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float dec = expf(__fmul_rn(dv[u], a[k]));
          h[k] = __fadd_rn(__fmul_rn(dec, h[k]), __fmul_rn(dx, bk[k]));
          const float term = __fmul_rn(h[k], ck[k]);
          acc = k == 0 ? term : __fadd_rn(acc, term);
        }
        ys[(long long)(t0 + s) * d_in] = __fadd_rn(acc, __fmul_rn(dd, xv[u]));
      }
    }
  }
  if (active) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(st)[q] =
          make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  }
}

template <int N>
int launch(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
           const float* D, float* state, float* y, int batch, int seq, int d_in,
           cudaStream_t stream) {
  const dim3 grid((d_in + kThreads - 1) / kThreads, batch);
  selective_scan_kernel<N><<<grid, kThreads, 0, stream>>>(x, dt, A, Bm, Cm, D, state, y, seq,
                                                          d_in);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dt, y: (batch, seq, d_in) float32; A: (d_in, n); Bm, Cm: (batch, seq, n);
// D: (d_in,); state: (batch, d_in, n), read and written in place.  n is 8 or 16.
extern "C" int repro_selective_scan(const void* x, const void* dt, const void* A, const void* Bm,
                                    const void* Cm, const void* D, void* state, void* y,
                                    int batch, int seq, int d_in, int n, void* stream) {
  if (batch < 1 || seq < 1 || d_in < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* df = static_cast<const float*>(dt);
  const auto* af = static_cast<const float*>(A);
  const auto* bf = static_cast<const float*>(Bm);
  const auto* cf = static_cast<const float*>(Cm);
  const auto* Df = static_cast<const float*>(D);
  auto* sf = static_cast<float*>(state);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return launch<8>(xf, df, af, bf, cf, Df, sf, yf, batch, seq, d_in, s);
    case 16: return launch<16>(xf, df, af, bf, cf, Df, sf, yf, batch, seq, d_in, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
