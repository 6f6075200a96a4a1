// The WKV-6 recurrence of RWKV-6 ("Finch"), a whole sequence in one launch.
// Per (sequence b, head h), with the state S of n x n floats:
//
//   a_t[i][j] = k_t[i] * v_t[j]
//   y_t[j]    = sum_i r_t[i] * (S[i][j] + u[i] * a_t[i][j])
//   S[i][j]  <- w_t[i] * S[i][j] + a_t[i][j]
//
// Replaces no Pallas kernel: the reference scans the recurrence with lax.scan
// (src/repro/models/rwkv.py:74, _wkv_scan), and a plain PyTorch loop over it
// would launch about six small operations a token and a layer.  Prefill runs
// it over a prompt from a zero state, decode over one token from the cache's
// state; both read the state from the (B, H, n, n) tensor they are given and
// write the final state back into it.  r, k, v, w are float32 (B, S, H, n),
// u float32 (H, n), y float32 (B, S, H, n); every row of n floats starts on a
// 16-byte boundary (the wrapper checks the tensors' addresses).
//
// Bound on an H100: bytes.  The function needs 5 float32 flops a
// (b, t, h, i, j), since y[j] = sum_i r[i] S[i][j] + v[j] sum_i r[i] u[i] k[i]
// (2 for y, 3 for S <- w S + k v) and 5n a (b, t, h) for the u term; at
// rwkv6-1.6b's served layer (B 8, S 2048, H 32, n 64) 1.09e10 flops, 163 us
// at 67 TFLOP/s, where its bytes (r, k, v, w read once, y written once:
// 5 * 4 * 33.5e6 B, and the state) take 203 us at 3.35 TB/s.  This design
// spends four FP32 instructions an (i, j) (the product k v and three fmas)
// and a quarter of four 16-byte shared loads, so the SMs' instruction rate,
// not the memory, is what it works against.
//
// Design (the formulation of RWKV's own CUDA forward): a block a (b, h) of n
// threads; thread j keeps column j of S in n registers for the whole
// sequence, so the state never leaves the SM between steps.  r, k, w and v
// of kChunk steps are staged in shared memory at once by cp.async, 16 bytes a
// copy, in two stages: the next chunk's copies are in flight while the
// block runs the current chunk's steps, which need no barrier between them
// (two a chunk).  A step reads r_t, k_t, w_t and u as float4 broadcasts.
// Each thread sums its y_j over i = 0 .. n-1 in order, in one accumulator,
// with explicit fmas: two runs agree bit for bit, and no atomics are used.
// n is a template argument (16, 32, 64), so the loop over i unrolls and S
// stays in registers.  At the served shape the grid is 256 blocks of 2 warps
// on 132 SMs: one warp a scheduler, no other warp to hide a stall behind.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;  // steps staged in shared memory at once

template <int N>
struct Stage {
  float r[kChunk][N];
  float k[kChunk][N];
  float w[kChunk][N];
  float v[kChunk][N];
};

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int Pending>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// Stage steps [t0, t0 + steps) of the head's r, k, w, v rows: thread
// threadIdx.x copies the float4 columns q = threadIdx.x, threadIdx.x + N, ...
template <int N>
__device__ __forceinline__ void stage_chunk(Stage<N>& st, const float* __restrict__ r,
                                            const float* __restrict__ k,
                                            const float* __restrict__ w,
                                            const float* __restrict__ v, long long head,
                                            long long row, int t0, int steps) {
  constexpr int kQuads = N / 4;
  for (int q = threadIdx.x; q < steps * kQuads; q += N) {
    const int s = q / kQuads, c = 4 * (q % kQuads);
    const long long at = head + (t0 + s) * row + c;
    copy16(&st.r[s][c], r + at);
    copy16(&st.k[s][c], k + at);
    copy16(&st.w[s][c], w + at);
    copy16(&st.v[s][c], v + at);
  }
  commit();
}

template <int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ state, float* __restrict__ y,
            int seq, int heads) {
  __shared__ __align__(16) Stage<N> stages[2];
  __shared__ __align__(16) float us[N];
  const int j = threadIdx.x;
  const int h = blockIdx.x % heads;
  const long long b = blockIdx.x / heads;
  const long long row = (long long)heads * N;  // elements from step t to step t + 1
  const long long head = (b * seq * heads + h) * N;  // (b, 0, h, 0)
  float* st = state + (long long)blockIdx.x * N * N + j;  // column j of (b, h)'s state

  const int chunks = (seq + kChunk - 1) / kChunk;
  stage_chunk<N>(stages[0], r, k, w, v, head, row, 0, min(kChunk, seq));
  float s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = st[i * N];
  us[j] = u[h * N + j];

  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * kChunk;
    if (c + 1 < chunks) {  // the next chunk's copies, in flight during this one
      stage_chunk<N>(stages[(c + 1) & 1], r, k, w, v, head, row, t0 + kChunk,
                     min(kChunk, seq - t0 - kChunk));
      wait_pending<1>();
    } else {
      wait_pending<0>();
    }
    __syncthreads();  // chunk c (and u) visible to every thread
    const Stage<N>& cur = stages[c & 1];
    const int steps = min(kChunk, seq - t0);
#pragma unroll 1
    for (int t = 0; t < steps; ++t) {
      const float vj = cur.v[t][j];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&cur.r[t][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&cur.k[t][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&cur.w[t][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = __fmul_rn(kk[e], vj);
          acc = __fmaf_rn(rr[e], __fmaf_rn(uu[e], a, s[i + e]), acc);
          s[i + e] = __fmaf_rn(ww[e], s[i + e], a);
        }
      }
      y[head + (t0 + t) * row + j] = acc;
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
#pragma unroll
  for (int i = 0; i < N; ++i) st[i * N] = s[i];
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           float* state, float* y, int batch, int seq, int heads, cudaStream_t stream) {
  wkv6_kernel<N><<<batch * heads, N, 0, stream>>>(r, k, v, w, u, state, y, seq, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, y: (batch, seq, heads, n) float32; u: (heads, n); state:
// (batch, heads, n, n), read and written in place.  n is 16, 32 or 64.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, void* state, void* y, int batch, int seq, int heads,
                          int n, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  auto* sf = static_cast<float*>(state);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16: return launch<16>(rf, kf, vf, wf, uf, sf, yf, batch, seq, heads, s);
    case 32: return launch<32>(rf, kf, vf, wf, uf, sf, yf, batch, seq, heads, s);
    case 64: return launch<64>(rf, kf, vf, wf, uf, sf, yf, batch, seq, heads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
