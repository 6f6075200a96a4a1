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
// floor the bound does not count: one MUFU.EX2 each, 16 an SM a clock, 1.03
// ms at 1.98 GHz.  So the SFU pipe and HBM, not the issue, are what this
// design works against.
//
// Design.  A block of 128 threads takes 128 channels of one sequence, grid
// (ceil(d_in / 128), B); a thread owns one channel, its n state values and
// its row of A, pre-scaled once to a' = A log2(e), in registers for the
// whole sequence.  A step of a (b, t, d, k) issues five instructions and a
// half: 2 dec = ex2.approx.ftz(fma(dt, a', 1)) (an FFMA and one MUFU.EX2),
// g = fma(2 dec, g, dx B_k) (an FMUL and an FFMA), acc = fma(g, C_k, acc) in
// k order (an FFMA), and half a broadcast shared load of B and C.  The SFU
// is given 1 + dt a', near 1 where a decay is near 1, as the accurate expf
// reduces dt A in [-ln 2, 0) (2^(1 + dt a') / 2); ex2.approx of dt a'
// itself, near 0, drifted the long-memory (slow dt) channels' state 2.2e-5
// of its largest from the plain version, past the 1e-5 gate, where this form
// reads 2.4e-6 as expf does (tools/time_selective_scan_designs.py
// --decays).  The halving is free: at a chunk's j-th step the state is kept
// as g = 2^j h, the drive dx = 2^j dt x and y = fma(D, x, 2^-j acc), and g
// is scaled back at the chunk's end; every scaling is by a power of two, so
// the numbers are those of dec = 0.5 ex2(..), h = fma(dec, h, (dt x) B_k),
// acc = fma(h, C_k, acc), y = fma(D, x, acc) bit for bit.  x and dt of
// kChunk steps of the block's 128 channels (16-byte cp.async; 4-byte where
// d_in % 4 != 0) and B and C of those steps reach shared memory in a ring
// of kStages chunks, so the next chunk's copies are in flight while a chunk
// is run: one block barrier a chunk.  y is stored coalesced (neighbouring
// threads, neighbouring channels).  The plan (kMinBlocks blocks an SM, the
// __launch_bounds__ minimum; kChunk; kStages; kUnroll steps unrolled) was
// chosen by tools/time_selective_scan_designs.py --sweep at the served
// layer: 3 blocks an SM with 139 registers, 32-step chunks in 2 stages,
// beat 8 blocks an SM at 64 registers (which spill) by a fifth.  The kernel
// never forms the reference's decay and drive tensors (17.2 GB each at the
// served layer).  Two runs agree bit for bit: no atomics, no order that
// depends on timing.
//
// A decode step (S = 1) is a kernel of its own: every load (the state, A, x,
// dt, D, and B and C straight from global memory) is issued before any
// arithmetic, with no shared staging of B or C and no block barrier.  The
// state and A are read, and the state written, as each warp's 32 contiguous
// rows, a float4 a lane an instruction, and handed to and from the threads
// that own the rows through a warp's shared copy (swizzled: no bank
// conflict).  Its arithmetic is the prefill kernel's step (a chunk of one),
// so a decode step from a state equals the prefill's step from it bit for
// bit.
//
// With SCAN_SWEEP_PLANS defined as "X(n, blocks, chunk, stages, unroll) ..."
// before this file is included (tools/time_selective_scan_designs.py
// --sweep), the library also exports repro_selective_scan_plan, which
// launches the prefill kernel at any of the listed plans, and
// repro_selective_scan_plan_blocks, its blocks an SM by the occupancy
// calculator.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels a block
constexpr int kMinBlocks = 3;  // blocks an SM (the __launch_bounds__ minimum)
constexpr int kChunk = 32;     // steps staged in shared memory at once
constexpr int kStages = 2;     // chunks in the ring: one in flight while one is run
constexpr int kUnroll = 4;     // steps of a chunk unrolled together
constexpr float kLog2e = 1.4426950408889634f;

// One slot of the ring: x and dt [chunk][kThreads], then B and C [chunk][N].
template <int N, int Chunk>
struct Slot {
  static constexpr int kDt = Chunk * kThreads;
  static constexpr int kB = 2 * Chunk * kThreads;
  static constexpr int kC = kB + Chunk * N;
  static constexpr int kFloats = kC + Chunk * N;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int Pending>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// N floats from global memory into registers, as N / 4 float4s.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    out[4 * q] = v.x, out[4 * q + 1] = v.y, out[4 * q + 2] = v.z, out[4 * q + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&h)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
}

// A row of B or C as float4 pieces: from shared memory (prefill) or from
// registers loaded before any arithmetic (a decode step).
struct SharedRow {
  const float* p;
  __device__ __forceinline__ float4 operator()(int q) const {
    return reinterpret_cast<const float4*>(p)[q];
  }
};
template <int N>
struct RegisterRow {
  float4 v[N / 4];
  __device__ __forceinline__ float4 operator()(int q) const { return v[q]; }
};

// One step of one channel, at the j-th step of a chunk (up = 2^j, down =
// 2^-j): the state is kept scaled, g = 2^j h, so the decay's 1/2 is the
// scale's and costs no instruction a k.  Every scaling is by a power of
// two, exact, so each g, each sum and y are those of the unscaled steps
//   dec = 0.5 ex2(fma(dt, a', 1)),  h = fma(dec, h, dx B_k),
//   acc = fma(h, C_k, acc) in k order,  y = fma(D, x, acc)
// bit for bit (short of h below 2^-126 in magnitude).
template <int N, typename Row>
__device__ __forceinline__ float step(float dv, float xv, float dd, float up, float down,
                                      const Row& b, const Row& c, float (&g)[N],
                                      const float (&a2)[N]) {
  const float dx = __fmul_rn(__fmul_rn(dv, xv), up);
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 b4 = b(q), c4 = c(q);
    const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
    const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      const float dec2 = ex2(__fmaf_rn(dv, a2[k], 1.0f));  // 2 dec
      g[k] = __fmaf_rn(dec2, g[k], __fmul_rn(dx, bb[e]));
      acc = k == 0 ? __fmul_rn(g[k], cc[e]) : __fmaf_rn(g[k], cc[e], acc);
    }
  }
  return __fmaf_rn(dd, xv, __fmul_rn(acc, down));
}

// Stage the (b, t) rows row .. row + steps - 1 of x and dt (the block's
// channels) and of B and C into one slot of the ring.
template <int N, int Chunk>
__device__ __forceinline__ void stage_chunk(float* slot, const float* __restrict__ x,
                                            const float* __restrict__ dt,
                                            const float* __restrict__ Bm,
                                            const float* __restrict__ Cm, long long row, int d0,
                                            int d_in, int steps, bool vec) {
  using Sl = Slot<N, Chunk>;
  if (vec) {  // 16-byte copies, a quad of channels each
    constexpr int kQuads = kThreads / 4;
    for (int q = threadIdx.x; q < steps * kQuads; q += kThreads) {
      const int s = q / kQuads, c = 4 * (q % kQuads);
      if (d0 + c < d_in) {
        const long long at = (row + s) * d_in + d0 + c;
        copy16(slot + s * kThreads + c, x + at);
        copy16(slot + Sl::kDt + s * kThreads + c, dt + at);
      }
    }
  } else if (d0 + (int)threadIdx.x < d_in) {  // each thread its own channel
    for (int s = 0; s < steps; ++s) {
      const long long at = (row + s) * d_in + d0 + threadIdx.x;
      copy4(slot + s * kThreads + threadIdx.x, x + at);
      copy4(slot + Sl::kDt + s * kThreads + threadIdx.x, dt + at);
    }
  }
  for (int q = threadIdx.x; q < steps * (N / 4); q += kThreads) {
    copy16(slot + Sl::kB + 4 * q, Bm + row * N + 4 * q);
    copy16(slot + Sl::kC + 4 * q, Cm + row * N + 4 * q);
  }
}

template <int N, int MinBlocks, int Chunk, int Stages, int Unroll>
__global__ void __launch_bounds__(kThreads, MinBlocks)
    selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ Cm, const float* __restrict__ D,
                          float* __restrict__ state, float* __restrict__ y, int seq, int d_in) {
  static_assert(N % 4 == 0, "a row of B, C, A or the state is whole float4s");
  static_assert(Stages >= 2, "a ring of at least two chunks");
  using Sl = Slot<N, Chunk>;
  extern __shared__ __align__(16) float smem[];
  const int d0 = blockIdx.x * kThreads;
  const int d = d0 + threadIdx.x;
  const bool active = d < d_in;
  const bool vec = (d_in & 3) == 0;
  const long long first = (long long)blockIdx.y * seq;  // the sequence's first (b, t) row
  const int chunks = (seq + Chunk - 1) / Chunk;
#pragma unroll
  for (int c = 0; c < Stages - 1; ++c) {  // one commit group a chunk, empty past the end
    if (c < chunks)
      stage_chunk<N, Chunk>(smem + c * Sl::kFloats, x, dt, Bm, Cm, first + c * Chunk, d0, d_in,
                            min(Chunk, seq - c * Chunk), vec);
    commit();
  }
  float h[N], a2[N], dd = 0.0f;
  float* st = state + ((long long)blockIdx.y * d_in + d) * N;
  if (active) {
    load_row<N>(st, h);
    load_row<N>(A + (long long)d * N, a2);
#pragma unroll
    for (int k = 0; k < N; ++k) a2[k] = __fmul_rn(a2[k], kLog2e);
    dd = D[d];
  }
  float* yp = y + first * d_in + d;

  for (int c = 0; c < chunks; ++c) {
    wait_pending<Stages - 2>();
    __syncthreads();  // chunk c visible; every thread done with chunk c - 1
    const int next = c + Stages - 1;  // into chunk c - 1's slot
    if (next < chunks)
      stage_chunk<N, Chunk>(smem + (next % Stages) * Sl::kFloats, x, dt, Bm, Cm,
                            first + next * Chunk, d0, d_in, min(Chunk, seq - next * Chunk), vec);
    commit();
    if (!active) continue;
    const float* cur = smem + (c % Stages) * Sl::kFloats;
    const int steps = min(Chunk, seq - c * Chunk);
    float up = 1.0f, down = 1.0f;  // 2^j, 2^-j: h is kept as 2^j h in the chunk
#pragma unroll(Unroll)
    for (int s = 0; s < steps; ++s) {
      const float xv = cur[s * kThreads + threadIdx.x];
      const float dv = cur[Sl::kDt + s * kThreads + threadIdx.x];
      up = __fmul_rn(up, 2.0f), down = __fmul_rn(down, 0.5f);
      *yp = step<N>(dv, xv, dd, up, down, SharedRow{cur + Sl::kB + s * N},
                    SharedRow{cur + Sl::kC + s * N}, h, a2);
      yp += d_in;
    }
#pragma unroll
    for (int k = 0; k < N; ++k) h[k] = __fmul_rn(h[k], down);
  }
  if (active) store_row<N>(st, h);
}

// The slot of piece p (a float4) of channel c's row in a warp's shared copy
// of its 32 rows: swizzled so that both the copy from coalesced pieces and
// each thread's read of its own row are free of bank conflicts.
template <int P>
__device__ __forceinline__ int slot(int c, int p) {
  return c * P + (p ^ ((c / (8 / P)) % P));
}

// A decode step: every load issued first, then one step of one channel.
// The state and A are read, and the state written, as the warp's 32
// contiguous rows, a float4 a lane an instruction, through a warp's
// shared copy.
template <int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_step_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                               const float* __restrict__ A, const float* __restrict__ Bm,
                               const float* __restrict__ Cm, const float* __restrict__ D,
                               float* __restrict__ state, float* __restrict__ y, int d_in) {
  constexpr int P = N / 4;  // float4 pieces of a row
  __shared__ float4 rows[kThreads / 32][2][32 * P];  // a warp's state and A rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * kThreads + warp * 32;  // the warp's first channel
  if (w0 >= d_in) return;  // the whole warp past the end; no block barrier follows
  const long long b = blockIdx.y;
  const int d = w0 + lane;
  const bool active = d < d_in;
  const int pieces = min(32, d_in - w0) * P;
  float4* st = reinterpret_cast<float4*>(state + (b * d_in + w0) * N);
  const float4* ar = reinterpret_cast<const float4*>(A + (long long)w0 * N);
  float4 hs[P], as[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (32 * i + lane < pieces) hs[i] = st[32 * i + lane], as[i] = ar[32 * i + lane];
  }
  RegisterRow<N> bq, cq;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    bq.v[q] = reinterpret_cast<const float4*>(Bm + b * N)[q];
    cq.v[q] = reinterpret_cast<const float4*>(Cm + b * N)[q];
  }
  float xv = 0.0f, dv = 0.0f, dd = 0.0f;
  if (active) xv = x[b * d_in + d], dv = dt[b * d_in + d], dd = D[d];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = 32 * i + lane;
    rows[warp][0][slot<P>(j / P, j % P)] = hs[i];
    rows[warp][1][slot<P>(j / P, j % P)] = as[i];
  }
  __syncwarp();
  float h[N], a2[N];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float4 hv = rows[warp][0][slot<P>(lane, p)], av = rows[warp][1][slot<P>(lane, p)];
    h[4 * p] = hv.x, h[4 * p + 1] = hv.y, h[4 * p + 2] = hv.z, h[4 * p + 3] = hv.w;
    a2[4 * p] = av.x, a2[4 * p + 1] = av.y, a2[4 * p + 2] = av.z, a2[4 * p + 3] = av.w;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) a2[k] = __fmul_rn(a2[k], kLog2e);
  const float yv = step<N>(dv, xv, dd, 2.0f, 0.5f, bq, cq, h, a2);
  if (active) y[b * d_in + d] = yv;
#pragma unroll
  for (int p = 0; p < P; ++p)  // each lane into the slots it alone read
    rows[warp][0][slot<P>(lane, p)] =
        make_float4(__fmul_rn(h[4 * p], 0.5f), __fmul_rn(h[4 * p + 1], 0.5f),
                    __fmul_rn(h[4 * p + 2], 0.5f), __fmul_rn(h[4 * p + 3], 0.5f));
  __syncwarp();
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = 32 * i + lane;
    if (j < pieces) st[j] = rows[warp][0][slot<P>(j / P, j % P)];
  }
}

template <int N, int Chunk, int Stages>
constexpr int smem_bytes() {
  return 4 * Stages * Slot<N, Chunk>::kFloats;
}

template <int N, int MinBlocks, int Chunk, int Stages, int Unroll>
int launch(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
           const float* D, float* state, float* y, int batch, int seq, int d_in,
           cudaStream_t stream) {
  const dim3 grid((d_in + kThreads - 1) / kThreads, batch);
  if (seq == 1) {
    selective_scan_step_kernel<N><<<grid, kThreads, 0, stream>>>(x, dt, A, Bm, Cm, D, state, y,
                                                                 d_in);
    return (int)cudaGetLastError();
  }
  constexpr int bytes = smem_bytes<N, Chunk, Stages>();
  auto* kernel = selective_scan_kernel<N, MinBlocks, Chunk, Stages, Unroll>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && bytes > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, bytes, stream>>>(x, dt, A, Bm, Cm, D, state, y, seq, d_in);
  return (int)cudaGetLastError();
}

template <int N, int MinBlocks, int Chunk, int Stages, int Unroll>
int blocks_an_sm(int* out) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, selective_scan_kernel<N, MinBlocks, Chunk, Stages, Unroll>, kThreads,
      smem_bytes<N, Chunk, Stages>());
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
    case 8:
      return launch<8, kMinBlocks, kChunk, kStages, kUnroll>(xf, df, af, bf, cf, Df, sf, yf,
                                                             batch, seq, d_in, s);
    case 16:
      return launch<16, kMinBlocks, kChunk, kStages, kUnroll>(xf, df, af, bf, cf, Df, sf, yf,
                                                              batch, seq, d_in, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef SCAN_SWEEP_PLANS
// As repro_selective_scan for seq > 1, at the plan (blocks an SM, chunk,
// stages, unroll) named, one of SCAN_SWEEP_PLANS.
extern "C" int repro_selective_scan_plan(const void* x, const void* dt, const void* A,
                                         const void* Bm, const void* Cm, const void* D,
                                         void* state, void* y, int batch, int seq, int d_in,
                                         int n, int blocks, int chunk, int stages, int unroll,
                                         void* stream) {
  if (batch < 1 || seq < 2 || d_in < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
#define X(NN, MB, CH, ST, UN)                                                                  \
  if (n == NN && blocks == MB && chunk == CH && stages == ST && unroll == UN)                  \
    return launch<NN, MB, CH, ST, UN>(                                                         \
        static_cast<const float*>(x), static_cast<const float*>(dt),                           \
        static_cast<const float*>(A), static_cast<const float*>(Bm),                           \
        static_cast<const float*>(Cm), static_cast<const float*>(D),                           \
        static_cast<float*>(state), static_cast<float*>(y), batch, seq, d_in,                  \
        static_cast<cudaStream_t>(stream));
  SCAN_SWEEP_PLANS
#undef X
  return (int)cudaErrorInvalidValue;
}

// The blocks an SM holds of the prefill kernel at a listed plan.
extern "C" int repro_selective_scan_plan_blocks(int n, int blocks, int chunk, int stages,
                                                int unroll, int* out) {
#define X(NN, MB, CH, ST, UN)                                                   \
  if (n == NN && blocks == MB && chunk == CH && stages == ST && unroll == UN) \
    return blocks_an_sm<NN, MB, CH, ST, UN>(out);
  SCAN_SWEEP_PLANS
#undef X
  return (int)cudaErrorInvalidValue;
}
#endif
