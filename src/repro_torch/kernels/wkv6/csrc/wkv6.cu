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
// 5 * 4 * 33.5e6 B, and the state) take 203 us at 3.35 TB/s.  What a kernel
// on the CUDA cores works against is the SMs' issue rate: an (i, j) needs
// three FP32 instructions at least (the product k_i v_j, an fma for S and
// one for y), 2.15e9 (i, j) at the served layer, 2.0e8 warp instructions,
// ~190 us on 528 schedulers at 1.98 GHz if nothing else were issued.
//
// Design.  The u term is factored out: y_j = sum_i r_i S_ij + v_j ru_t with
// ru_t = sum_i r_i u_i k_i, one dot a (b, t, h), so a step issues those three
// FP32 instructions an (i, j) and no fourth.  A block a (b, h) cuts each
// column's n rows into P blocks of n / P and gives a thread one row block of
// C adjacent columns (Plan<n>, from tools/time_wkv6_designs.py --sweep; at
// n = 64 P = 8 and C = 4: 128 threads, 32 state registers a thread, two
// blocks an SM at the served shape, 2 warps a scheduler).  The state stays
// in registers for the whole sequence.  A step issues, a thread, the FP32
// work of its (n / P) C (i, j), 3n / 4P float4 broadcast loads of r, k, w
// (each loaded once for its C columns), one load of v and one store of its
// C partial sums of y: at n = 64, 104 instructions for 32 (i, j), 3.25 an
// (i, j).  A chunk's partial sums go to shared memory, and at the chunk's
// end each thread finishes 4 adjacent y of one step at a time: the P
// partials summed in the order p = 0 .. P-1, ru_t (its 4 terms in order,
// then a fixed xor-shuffle tree over the step's n / 4 threads), y_j =
// fma(v_j, ru_t, sum), one 16-byte store.  That pass issues ~0.25 slots an
// (i, j), but its 12 16-byte shared loads an item make it the costliest part
// after the FP32 work: 59 us of 389 at the served layer, the steps' FP32
// work and the staging alone 251 us (tools/time_wkv6_designs.py --parts,
// NVIDIA H100 80GB HBM3, 700 W).  A plan with 4 warps a scheduler (P = 8,
// C = 2) loads and stores twice as much an (i, j) and measured slower (445
// us), as did, in development runs, a warp of the block that finished y
// while the others ran steps, and y finished between slices of the next
// chunk's steps.  Two runs agree bit for bit; no atomics.  r, k, w and v of
// kChunk steps reach shared memory by 16-byte cp.async in a ring of kStages
// chunks, two chunks' copies in flight while one is run; two block barriers
// a chunk (its data arrived; its partials written).
//
// With WKV6_SWEEP_PLANS defined as "X(n, P, C) ..." before this file is
// included (tools/time_wkv6_designs.py --sweep), the library also exports
// repro_wkv6_plan, which launches any of the listed plans: the sweep that
// chose Plan<n>.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;  // steps staged in shared memory at once
constexpr int kStages = 3;  // chunks in the ring: two in flight while one is run

// The plan of head dim n: the rows of a column in kRowBlocks blocks, a
// thread one block of kCols adjacent columns.
template <int N>
struct Plan;
template <>
struct Plan<16> { static constexpr int kRowBlocks = 4, kCols = 2; };
template <>
struct Plan<32> { static constexpr int kRowBlocks = 8, kCols = 4; };
template <>
struct Plan<64> { static constexpr int kRowBlocks = 8, kCols = 4; };

template <int N, int P, int C>
struct Shape {
  static constexpr int kRows = N / P;             // rows of a thread's block
  static constexpr int kGroups = N / C;           // column groups
  static constexpr int kThreads = P * kGroups;
  static constexpr int kQuads = N / 4;            // float4 pieces of a row
  static constexpr int kItems = kChunk * kQuads;  // 4-column pieces of y a chunk
  static constexpr int kStageFloats = 4 * kChunk * N;  // r, k, w, v of a chunk
  static constexpr int kPartFloats = kChunk * P * N;   // a chunk's partial sums of y
  static constexpr int kSmemBytes = 4 * (kStages * kStageFloats + kPartFloats + N);
  static_assert(N % P == 0 && kRows % 4 == 0, "a row block is whole float4 loads");
  static_assert(C == 1 || C == 2 || C == 4, "C columns are one 4-, 8- or 16-byte access");
  static_assert(kThreads % 32 == 0 && kThreads <= 1024 && kThreads >= N, "whole warps");
  static_assert(kItems % 32 == 0 && kQuads <= 32, "a step's pieces of y are whole lanes");
};

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int Pending>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// C adjacent floats, one access.
__device__ __forceinline__ void load(const float* p, float (&x)[1]) { x[0] = *p; }
__device__ __forceinline__ void load(const float* p, float (&x)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  x[0] = q.x, x[1] = q.y;
}
__device__ __forceinline__ void load(const float* p, float (&x)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
}
__device__ __forceinline__ void store(float* p, const float (&x)[1]) { *p = x[0]; }
__device__ __forceinline__ void store(float* p, const float (&x)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ void store(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// Stage steps [t0, t0 + steps) of the head's r, k, w, v rows into one slot
// of the ring (r, k, w, v each [kChunk][N]), a 16-byte copy a float4.
template <int N, int Threads>
__device__ __forceinline__ void stage_chunk(float* slot, const float* __restrict__ r,
                                            const float* __restrict__ k,
                                            const float* __restrict__ w,
                                            const float* __restrict__ v, long long head,
                                            long long row, int t0, int steps) {
  constexpr int kQuads = N / 4;
  for (int q = threadIdx.x; q < steps * kQuads; q += Threads) {
    const int s = q / kQuads, c = 4 * (q % kQuads);
    const long long at = head + (t0 + s) * row + c;
    float* dst = slot + s * N + c;
    copy16(dst, r + at);
    copy16(dst + kChunk * N, k + at);
    copy16(dst + 2 * kChunk * N, w + at);
    copy16(dst + 3 * kChunk * N, v + at);
  }
}

// The steps of one chunk on the thread of rows R p.. and columns C q..: its
// partial sums of y into part [kChunk][P][N], its state updated.
template <int N, int P, int C>
__device__ __forceinline__ void run_steps(const float* __restrict__ cur, float* __restrict__ part,
                                          int steps, int p, int q, float (&s)[N / P][C]) {
  constexpr int R = N / P;
  const float* cr = cur;
  const float* ck = cur + kChunk * N;
  const float* cw = cur + 2 * kChunk * N;
  const float* cv = cur + 3 * kChunk * N;
#pragma unroll 4
  for (int t = 0; t < steps; ++t) {
    float vj[C], acc[C];
    load(cv + t * N + C * q, vj);
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(cr + t * N + R * p + i);
      const float4 k4 = *reinterpret_cast<const float4*>(ck + t * N + R * p + i);
      const float4 w4 = *reinterpret_cast<const float4*>(cw + t * N + R * p + i);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float a = __fmul_rn(kk[e], vj[j]);
          acc[j] = __fmaf_rn(rr[e], s[i + e][j], acc[j]);
          s[i + e][j] = __fmaf_rn(ww[e], s[i + e][j], a);
        }
      }
    }
    store(part + (t * P + p) * N + C * q, acc);
  }
}

// y of one chunk: a thread 4 adjacent columns of one step at a time.
// y_j = fma(v_j, ru_t, the P partials summed in order), ru_t = a piece's 4
// terms r u k in order, then an xor-shuffle tree over the step's n / 4 lanes.
template <int N, int P, int Threads>
__device__ __forceinline__ void finish_y(const float* __restrict__ cur,
                                         const float* __restrict__ part,
                                         const float* __restrict__ us, float* __restrict__ y,
                                         long long at, long long row, int steps) {
  constexpr int kQuads = N / 4;
  const float* cr = cur;
  const float* ck = cur + kChunk * N;
  const float* cv = cur + 3 * kChunk * N;
  for (int base = 0; base < kChunk * kQuads; base += Threads) {
    const int item = base + threadIdx.x;
    if (item >= kChunk * kQuads) break;  // whole warps: both counts are multiples of 32
    const int t = item / kQuads, c4 = 4 * (item % kQuads);
    const float4 r4 = *reinterpret_cast<const float4*>(cr + t * N + c4);
    const float4 k4 = *reinterpret_cast<const float4*>(ck + t * N + c4);
    const float4 u4 = *reinterpret_cast<const float4*>(us + c4);
    float ru = __fmul_rn(__fmul_rn(r4.x, u4.x), k4.x);
    ru = __fmaf_rn(__fmul_rn(r4.y, u4.y), k4.y, ru);
    ru = __fmaf_rn(__fmul_rn(r4.z, u4.z), k4.z, ru);
    ru = __fmaf_rn(__fmul_rn(r4.w, u4.w), k4.w, ru);
#pragma unroll
    for (int off = 1; off < kQuads; off <<= 1)
      ru = __fadd_rn(ru, __shfl_xor_sync(0xffffffffu, ru, off));
    float4 sum = *reinterpret_cast<const float4*>(part + t * P * N + c4);
#pragma unroll
    for (int pp = 1; pp < P; ++pp) {
      const float4 x = *reinterpret_cast<const float4*>(part + (t * P + pp) * N + c4);
      sum.x = __fadd_rn(sum.x, x.x), sum.y = __fadd_rn(sum.y, x.y);
      sum.z = __fadd_rn(sum.z, x.z), sum.w = __fadd_rn(sum.w, x.w);
    }
    const float4 v4 = *reinterpret_cast<const float4*>(cv + t * N + c4);
    if (t < steps)
      *reinterpret_cast<float4*>(y + at + t * row + c4) =
          make_float4(__fmaf_rn(v4.x, ru, sum.x), __fmaf_rn(v4.y, ru, sum.y),
                      __fmaf_rn(v4.z, ru, sum.z), __fmaf_rn(v4.w, ru, sum.w));
  }
}

template <int N, int P, int C>
__global__ void __launch_bounds__(Shape<N, P, C>::kThreads, 2)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ state, float* __restrict__ y,
            int seq, int heads) {
  using Sh = Shape<N, P, C>;
  constexpr int R = Sh::kRows;
  extern __shared__ __align__(16) float smem[];
  float* part = smem + kStages * Sh::kStageFloats;  // [kChunk][P][N]
  float* us = part + Sh::kPartFloats;               // [N]
  const int tid = threadIdx.x;
  const int q = tid % Sh::kGroups, p = tid / Sh::kGroups;  // columns C q.., rows R p..
  const int h = blockIdx.x % heads;
  const long long b = blockIdx.x / heads;
  const long long row = (long long)heads * N;  // elements from step t to step t + 1
  const long long head = (b * seq * heads + h) * N;  // (b, 0, h, 0)
  float* st = state + (long long)blockIdx.x * N * N + (R * p) * N + C * q;

  const int chunks = (seq + kChunk - 1) / kChunk;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {  // one commit group a chunk, empty past the end
    if (c < chunks)
      stage_chunk<N, Sh::kThreads>(smem + c * Sh::kStageFloats, r, k, w, v, head, row,
                                   c * kChunk, min(kChunk, seq - c * kChunk));
    commit();
  }
  if (tid < N) us[tid] = u[h * N + tid];
  float s[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) load(st + i * N, s[i]);

  for (int c = 0; c < chunks; ++c) {
    wait_pending<kStages - 2>();
    __syncthreads();  // chunk c (and u) visible; every thread done with chunk c - 1
    const int next = c + kStages - 1;  // into chunk c - 1's slot
    if (next < chunks)
      stage_chunk<N, Sh::kThreads>(smem + (next % kStages) * Sh::kStageFloats, r, k, w, v, head,
                                   row, next * kChunk, min(kChunk, seq - next * kChunk));
    commit();
    const float* cur = smem + (c % kStages) * Sh::kStageFloats;
    const int steps = min(kChunk, seq - c * kChunk);
    run_steps<N, P, C>(cur, part, steps, p, q, s);
    __syncthreads();  // the chunk's partial sums written
    finish_y<N, P, Sh::kThreads>(cur, part, us, y, head + (long long)c * kChunk * row, row, steps);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) store(st + i * N, s[i]);
}

template <int N, int P, int C>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           float* state, float* y, int batch, int seq, int heads, cudaStream_t stream) {
  using Sh = Shape<N, P, C>;
  if (Sh::kSmemBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<N, P, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
  }
  wkv6_kernel<N, P, C><<<batch * heads, Sh::kThreads, Sh::kSmemBytes, stream>>>(
      r, k, v, w, u, state, y, seq, heads);
  return (int)cudaGetLastError();
}

template <int N>
int launch_plan(const float* r, const float* k, const float* v, const float* w, const float* u,
                float* state, float* y, int batch, int seq, int heads, cudaStream_t stream) {
  return launch<N, Plan<N>::kRowBlocks, Plan<N>::kCols>(r, k, v, w, u, state, y, batch, seq,
                                                         heads, stream);
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
    case 16: return launch_plan<16>(rf, kf, vf, wf, uf, sf, yf, batch, seq, heads, s);
    case 32: return launch_plan<32>(rf, kf, vf, wf, uf, sf, yf, batch, seq, heads, s);
    case 64: return launch_plan<64>(rf, kf, vf, wf, uf, sf, yf, batch, seq, heads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef WKV6_SWEEP_PLANS
// As repro_wkv6, at the plan (P row blocks, C columns a thread) named, one of
// WKV6_SWEEP_PLANS.
extern "C" int repro_wkv6_plan(const void* r, const void* k, const void* v, const void* w,
                               const void* u, void* state, void* y, int batch, int seq,
                               int heads, int n, int p, int c, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1) return (int)cudaErrorInvalidValue;
#define X(NN, PP, CC)                                                                         \
  if (n == NN && p == PP && c == CC)                                                          \
    return launch<NN, PP, CC>(static_cast<const float*>(r), static_cast<const float*>(k),    \
                              static_cast<const float*>(v), static_cast<const float*>(w),    \
                              static_cast<const float*>(u), static_cast<float*>(state),      \
                              static_cast<float*>(y), batch, seq, heads,                     \
                              static_cast<cudaStream_t>(stream));
  WKV6_SWEEP_PLANS
#undef X
  return (int)cudaErrorInvalidValue;
}
#endif
