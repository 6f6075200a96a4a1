// The gradient of the WKV-6 recurrence (wkv6.cu), a whole sequence in two launches.
// Per (sequence b, head h), with the state S and its gradient G = dL/dS of n x n
// floats (row index i of r, k, w, u; column j of v), G_T = 0 (training drops the
// final state), going backward over t:
//
//   dv_t[j] = sum_i G_t[i][j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//   dk_t[i] = sum_j G_t[i][j] v_t[j] + r_t[i] u[i] c_t,     c_t = v_t . dy_t
//   dr_t[i] = sum_j S_{t-1}[i][j] dy_t[j] + u[i] k_t[i] c_t
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]  += r_t[i] k_t[i] c_t                          (over b and t)
//   G_{t-1}[i][j] = w_t[i] G_t[i][j] + r_t[i] dy_t[j]
//
// Replaces no Pallas kernel: the reference trains through JAX's autodiff of the
// lax.scan of src/repro/models/rwkv.py:74 (_wkv_scan); kernels/wkv6/ref.py's
// wkv6_bwd_ref is the loop above in PyTorch, which this kernel is held to.  dw
// is the direct sum of G (.) S_{t-1}, as autodiff computes it, not the
// suffix-sum identity for d(log w) that RWKV's own kernels use (a difference
// of two sums over every later step, which cancels in float32 over thousands
// of steps and divides by w).
//
// Bound on an H100: operations.  14 float32 flops an (b, t, h, i, j): S
// recomputed (k v, w S, their sum: 3), G (w G, r dy, their sum: 3), and a
// product and a sum each for dr, dk, dv and dw; at rwkv6-1.6b's training
// microbatch (B 2, S 4096, H 32, n 64) 1.07e9 (b, t, h, i, j), 1.50e10 flops,
// 224 us at 67 TFLOP/s, where its bytes (r, k, v, w and dy read once, dr, dk,
// dv and dw written once: 9 * 67.1 MB) take 180 us at 3.35 TB/s.
//
// Design.  Every (i, j) of S and of G evolves on its own: only the outputs
// couple them (dv sums over i, dr, dk and dw over j).  So launch 1 gives a
// block of one warp a (b, h, slice of kRows = 16 rows), all n columns: at the
// training microbatch B * H * n / 16 = 256 blocks, two an SM (a block a (b, h)
// would give 64 blocks for 132 SMs).  Lane (p, q) holds rows 2p, 2p + 1 of the
// slice and columns q n/4 .. of S and of G in registers (2 n/4 each).
//   - It first runs the recurrence forward from state0 and writes S at the
//     start of every kChunk-step chunk into a float32 scratch (n^2 floats a
//     chunk and (b, h): 268 MB at the training microbatch).
//   - It then walks the chunks in reverse: reloads a chunk's checkpoint,
//     recomputes the chunk's kChunk states S_{t-1} into shared memory (64 KB
//     at n = 64), and runs the chunk's steps in descending order with G in
//     registers.  dr, dk and dw of its rows are sums over a lane's columns,
//     then over the 4 lanes of a row pair by two xor shuffles, and are
//     complete (the u terms added: c_t is summed the same way); du of its
//     rows adds up over t in a register.  dv's sum over the slice's rows goes
//     through shared memory a row pair at a time and is added in order of
//     the pair every kFlush steps into a float32 partial of the slice.
//   - r, k, w of the slice's rows and v, dy of the step reach shared memory
//     by 16-byte cp.async, a chunk at a time, in a ring of two chunks.
// Launch 2 sums dv's partials over the slices in order, and du over b in
// order.  No atomics: every sum has a fixed order, two runs give the same bits.
//
// r, k, v, w, dy, dr, dk, dv, dw: float32 (B, S, H, n); u, du: (H, n); state0:
// (B, H, n, n); every row of n floats on a 16-byte boundary (the wrapper checks
// the tensors' addresses).

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;  // steps a checkpoint covers, recomputed into shared memory
constexpr int kRows = 16;   // rows of the state a block
constexpr int kLanes = 32;  // a block: one warp, 8 row pairs x 4 column groups
constexpr int kFlush = 8;   // steps of dv partials in shared memory before they are summed

template <int N>
struct Plan {
  static constexpr int kC = N / 4;          // columns of a lane
  static constexpr int kSlices = N / kRows;  // row slices of a head
  static constexpr int kVec = 2 * kC / 4;    // float4 pieces of a lane's 2 x kC state
  static constexpr int kStepFloats = 3 * kRows + 2 * N;     // r, k, w of the slice; v, dy
  static constexpr int kStageFloats = kChunk * kStepFloats;
  static constexpr int kHistFloats = kChunk * kLanes * 2 * kC;  // a chunk's S_{t-1}
  static constexpr int kDvFloats = kFlush * (kRows / 2) * N;    // dv partials a row pair
  static constexpr int kSmemBytes = 4 * (2 * kStageFloats + kHistFloats + kDvFloats);
  static_assert(N % kRows == 0 && kC % 4 == 0, "whole slices; a lane's columns whole float4s");
};

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void wait_one_pending() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage steps [t0, t0 + steps) into a slot laid out r, k, w [kChunk][kRows] (the
// slice's rows), v, dy [kChunk][N]; the forward walk needs only k, w and v.
template <int N>
__device__ __forceinline__ void stage_chunk(float* slot, const float* __restrict__ r,
                                            const float* __restrict__ k,
                                            const float* __restrict__ w,
                                            const float* __restrict__ v,
                                            const float* __restrict__ dy, long long head,
                                            long long row, int i_first, int t0, int steps,
                                            bool backward) {
  constexpr int kRowQuads = kRows / 4, kQuads = N / 4;
  float* rs = slot;
  float* ks = rs + kChunk * kRows;
  float* ws = ks + kChunk * kRows;
  float* vs = ws + kChunk * kRows;
  float* dys = vs + kChunk * N;
  for (int x = threadIdx.x; x < steps * kRowQuads; x += kLanes) {
    const int s = x / kRowQuads, c = 4 * (x % kRowQuads);
    const long long at = head + (t0 + s) * row + i_first + c;
    if (backward) copy16(rs + s * kRows + c, r + at);
    copy16(ks + s * kRows + c, k + at);
    copy16(ws + s * kRows + c, w + at);
  }
  for (int x = threadIdx.x; x < steps * kQuads; x += kLanes) {
    const int s = x / kQuads, c = 4 * (x % kQuads);
    const long long at = head + (t0 + s) * row + c;
    copy16(vs + s * N + c, v + at);
    if (backward) copy16(dys + s * N + c, dy + at);
  }
}

// The lane's two rows of S advanced over `steps` staged steps; where `hist` is
// given, S before each step is kept there first ([step][kVec][lane] float4).
template <int N>
__device__ __forceinline__ void forward_steps(const float* __restrict__ slot, int steps, int p,
                                              int q, float (&s)[2][N / 4], float4* hist) {
  constexpr int C = N / 4, kVec = Plan<N>::kVec;
  const float* ks = slot + kChunk * kRows;
  const float* ws = ks + kChunk * kRows;
  const float* vs = ws + kChunk * kRows;
  for (int t = 0; t < steps; ++t) {
    if (hist != nullptr) {
#pragma unroll
      for (int x = 0; x < kVec; ++x) {
        const int e = (4 * x) / C, c = (4 * x) % C;
        hist[(t * kVec + x) * kLanes + threadIdx.x] =
            make_float4(s[e][c], s[e][c + 1], s[e][c + 2], s[e][c + 3]);
      }
    }
    const float2 k2 = *reinterpret_cast<const float2*>(ks + t * kRows + 2 * p);
    const float2 w2 = *reinterpret_cast<const float2*>(ws + t * kRows + 2 * p);
    const float kk[2] = {k2.x, k2.y}, ww[2] = {w2.x, w2.y};
#pragma unroll
    for (int c4 = 0; c4 < C; c4 += 4) {
      const float4 v4 = *reinterpret_cast<const float4*>(vs + t * N + C * q + c4);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[e][c4 + c] = __fmaf_rn(ww[e], s[e][c4 + c], __fmul_rn(kk[e], vv[c]));
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kLanes, 2)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ state0,
                const float* __restrict__ dy, float4* __restrict__ ckpt, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dw, float* __restrict__ dv_part,
                float* __restrict__ du_part, int seq, int heads) {
  using P = Plan<N>;
  constexpr int C = P::kC, kVec = P::kVec;
  extern __shared__ __align__(16) float smem[];
  float4* hist = reinterpret_cast<float4*>(smem + 2 * P::kStageFloats);
  float* dvb = smem + 2 * P::kStageFloats + P::kHistFloats;  // [kFlush][kRows / 2][N]
  const int lane = threadIdx.x, p = lane >> 2, q = lane & 3;
  const int slice = blockIdx.x % P::kSlices;
  const int bh = blockIdx.x / P::kSlices;  // b * heads + h
  const int h = bh % heads;
  const long long b = bh / heads;
  const long long row = (long long)heads * N;        // elements from step t to t + 1
  const long long head = (b * seq * heads + h) * N;  // (b, 0, h, 0)
  const int i_first = slice * kRows, i0 = i_first + 2 * p;  // the lane's rows i0, i0 + 1
  const int chunks = (seq + kChunk - 1) / kChunk;
  float4* my_ckpt = ckpt + (long long)blockIdx.x * chunks * kVec * kLanes + lane;

  float s[2][C];
  {
    const float* s0 = state0 + ((long long)bh * N + i0) * N + C * q;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < C; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(s0 + e * N + c);
        s[e][c] = x.x, s[e][c + 1] = x.y, s[e][c + 2] = x.z, s[e][c + 3] = x.w;
      }
  }

  // 1. forward from state0: S at the start of each chunk into the scratch
  stage_chunk<N>(smem, r, k, w, v, dy, head, row, i_first, 0, min(kChunk, seq), false);
  commit();
  for (int c = 0; c < chunks; ++c) {
#pragma unroll
    for (int x = 0; x < kVec; ++x) {
      const int e = (4 * x) / C, cc = (4 * x) % C;
      my_ckpt[(c * kVec + x) * kLanes] =
          make_float4(s[e][cc], s[e][cc + 1], s[e][cc + 2], s[e][cc + 3]);
    }
    if (c + 1 < chunks)
      stage_chunk<N>(smem + ((c + 1) & 1) * P::kStageFloats, r, k, w, v, dy, head, row, i_first,
                     (c + 1) * kChunk, min(kChunk, seq - (c + 1) * kChunk), false);
    commit();
    wait_one_pending();
    __syncthreads();  // chunk c arrived, every lane's copies
    if (c + 1 < chunks)  // the last chunk's states are not needed
      forward_steps<N>(smem + (c & 1) * P::kStageFloats, kChunk, p, q, s, nullptr);
    __syncthreads();  // done with chunk c's slot before chunk c + 2 is staged into it
  }
  __syncthreads();  // the scratch written by every lane is read back by the same lanes only

  // 2. backward over the chunks in reverse
  float g[2][C];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int c = 0; c < C; ++c) g[e][c] = 0.0f;
  const float2 u2 = *reinterpret_cast<const float2*>(u + h * N + i0);
  const float uu[2] = {u2.x, u2.y};
  float du[2] = {0.0f, 0.0f};
  // dr, dk, dw rows written by lanes q = 0, 1, 2 of each row pair
  float* out = q == 0 ? dr : q == 1 ? dk : dw;
  const long long plane = (long long)(gridDim.x / P::kSlices) * seq * N;  // B * S * H * n
  float* my_dv = dv_part + slice * plane + head;  // the slice's partial of dv

  {
    const int c = chunks - 1;
    stage_chunk<N>(smem, r, k, w, v, dy, head, row, i_first, c * kChunk, seq - c * kChunk, true);
    commit();
  }
  for (int c = chunks - 1, it = 0; c >= 0; --c, ++it) {
    const float* slot = smem + (it & 1) * P::kStageFloats;
    if (c > 0)
      stage_chunk<N>(smem + ((it + 1) & 1) * P::kStageFloats, r, k, w, v, dy, head, row, i_first,
                     (c - 1) * kChunk, kChunk, true);
    commit();
    wait_one_pending();
    __syncthreads();  // chunk c arrived
    const int steps = min(kChunk, seq - c * kChunk);
#pragma unroll
    for (int x = 0; x < kVec; ++x) {
      const float4 y = my_ckpt[(c * kVec + x) * kLanes];
      const int e = (4 * x) / C, cc = (4 * x) % C;
      s[e][cc] = y.x, s[e][cc + 1] = y.y, s[e][cc + 2] = y.z, s[e][cc + 3] = y.w;
    }
    forward_steps<N>(slot, steps, p, q, s, hist);
    const float* rs = slot;
    const float* ks = rs + kChunk * kRows;
    const float* ws = ks + kChunk * kRows;
    const float* vs = ws + kChunk * kRows;
    const float* dys = vs + kChunk * N;
    for (int t = steps - 1; t >= 0; --t) {
      const long long tg = (long long)c * kChunk + t;  // the step's index in the sequence
      const float2 r2 = *reinterpret_cast<const float2*>(rs + t * kRows + 2 * p);
      const float2 k2 = *reinterpret_cast<const float2*>(ks + t * kRows + 2 * p);
      const float2 w2 = *reinterpret_cast<const float2*>(ws + t * kRows + 2 * p);
      const float rr[2] = {r2.x, r2.y}, kk[2] = {k2.x, k2.y}, ww[2] = {w2.x, w2.y};
      float vv[C], dd[C], sp[2][C];
#pragma unroll
      for (int c4 = 0; c4 < C; c4 += 4) {
        const float4 a = *reinterpret_cast<const float4*>(vs + t * N + C * q + c4);
        const float4 d = *reinterpret_cast<const float4*>(dys + t * N + C * q + c4);
        vv[c4] = a.x, vv[c4 + 1] = a.y, vv[c4 + 2] = a.z, vv[c4 + 3] = a.w;
        dd[c4] = d.x, dd[c4 + 1] = d.y, dd[c4 + 2] = d.z, dd[c4 + 3] = d.w;
      }
#pragma unroll
      for (int x = 0; x < kVec; ++x) {
        const float4 y = hist[(t * kVec + x) * kLanes + lane];
        const int e = (4 * x) / C, cc = (4 * x) % C;
        sp[e][cc] = y.x, sp[e][cc + 1] = y.y, sp[e][cc + 2] = y.z, sp[e][cc + 3] = y.w;
      }
      // the lane's sums over its columns, in order of j: dr, dk, dw of both
      // rows, and its part of c_t
      float part[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          part[e] = __fmaf_rn(sp[e][cc], dd[cc], part[e]);
          part[2 + e] = __fmaf_rn(g[e][cc], vv[cc], part[2 + e]);
          part[4 + e] = __fmaf_rn(g[e][cc], sp[e][cc], part[4 + e]);
        }
        part[6] = __fmaf_rn(vv[cc], dd[cc], part[6]);
      }
#pragma unroll
      for (int x = 0; x < 7; ++x) {  // over the row pair's 4 lanes, then all 32 for c_t
        part[x] = __fadd_rn(part[x], __shfl_xor_sync(0xffffffffu, part[x], 1));
        part[x] = __fadd_rn(part[x], __shfl_xor_sync(0xffffffffu, part[x], 2));
      }
      const float ct = part[6];
      // dv over the lane's two rows, with their share of the u term
      const float ruk = __fmaf_rn(__fmul_rn(rr[1], uu[1]), kk[1],
                                  __fmul_rn(__fmul_rn(rr[0], uu[0]), kk[0]));
      float* dvrow = dvb + ((t % kFlush) * (kRows / 2) + p) * N + C * q;
#pragma unroll
      for (int c4 = 0; c4 < C; c4 += 4) {
        float x4[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float a = __fmaf_rn(g[1][c4 + c], kk[1], __fmul_rn(g[0][c4 + c], kk[0]));
          x4[c] = __fmaf_rn(ruk, dd[c4 + c], a);
        }
        *reinterpret_cast<float4*>(dvrow + c4) = make_float4(x4[0], x4[1], x4[2], x4[3]);
      }
      float res[3][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        res[0][e] = __fmaf_rn(__fmul_rn(uu[e], kk[e]), ct, part[e]);      // dr
        res[1][e] = __fmaf_rn(__fmul_rn(rr[e], uu[e]), ct, part[2 + e]);  // dk
        res[2][e] = part[4 + e];                                          // dw
        du[e] = __fmaf_rn(__fmul_rn(rr[e], kk[e]), ct, du[e]);
      }
      if (q < 3) {
        const float2 o = q == 0 ? make_float2(res[0][0], res[0][1])
                                : q == 1 ? make_float2(res[1][0], res[1][1])
                                         : make_float2(res[2][0], res[2][1]);
        *reinterpret_cast<float2*>(out + head + tg * row + i0) = o;
      }
      // G_{t-1} = w_t G_t + r_t dy_t
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int cc = 0; cc < C; ++cc)
          g[e][cc] = __fmaf_rn(ww[e], g[e][cc], __fmul_rn(rr[e], dd[cc]));
      if (t % kFlush == 0) {  // dv of steps t .. the window's last: the row pairs in order
        __syncthreads();
        const int last = min(steps, t + kFlush);
        constexpr int kQuads = N / 4;
        for (int x = lane; x < kFlush * kQuads; x += kLanes) {
          const int tt = t + x / kQuads, j = 4 * (x % kQuads);
          if (tt >= last) break;  // x only grows with tt
          const float* src = dvb + ((tt % kFlush) * (kRows / 2)) * N + j;
          float4 acc = *reinterpret_cast<const float4*>(src);
#pragma unroll
          for (int pp = 1; pp < kRows / 2; ++pp) {
            const float4 y = *reinterpret_cast<const float4*>(src + pp * N);
            acc.x = __fadd_rn(acc.x, y.x), acc.y = __fadd_rn(acc.y, y.y);
            acc.z = __fadd_rn(acc.z, y.z), acc.w = __fadd_rn(acc.w, y.w);
          }
          *reinterpret_cast<float4*>(my_dv + ((long long)c * kChunk + tt) * row + j) = acc;
        }
        __syncthreads();
      }
    }
    __syncthreads();  // done with this chunk's slot and states before they are overwritten
  }
  if (q == 0)
    *reinterpret_cast<float2*>(du_part + (long long)bh * N + i0) = make_float2(du[0], du[1]);
}

// Launch 2: dv = the slices' partials summed in order; du = the sequences'
// partials summed in order of b.
__global__ void wkv6_bwd_sum(const float4* __restrict__ dv_part, float4* __restrict__ dv,
                             const float* __restrict__ du_part, float* __restrict__ du,
                             long long quads, int slices, int batch, int hn) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x < quads) {
    float4 acc = dv_part[x];
    for (int s = 1; s < slices; ++s) {
      const float4 y = dv_part[s * quads + x];
      acc.x = __fadd_rn(acc.x, y.x), acc.y = __fadd_rn(acc.y, y.y);
      acc.z = __fadd_rn(acc.z, y.z), acc.w = __fadd_rn(acc.w, y.w);
    }
    dv[x] = acc;
  }
  if (x < hn) {
    float acc = du_part[x];
    for (int b = 1; b < batch; ++b) acc = __fadd_rn(acc, du_part[(long long)b * hn + x]);
    du[x] = acc;
  }
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* state0, const float* dy, float* ckpt, float* dr, float* dk, float* dv,
           float* dw, float* du, float* dv_part, float* du_part, int batch, int seq, int heads,
           cudaStream_t stream) {
  using P = Plan<N>;
  cudaError_t e = cudaFuncSetAttribute(wkv6_bwd_kernel<N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_kernel<N><<<batch * heads * P::kSlices, kLanes, P::kSmemBytes, stream>>>(
      r, k, v, w, u, state0, dy, reinterpret_cast<float4*>(ckpt), dr, dk, dw, dv_part, du_part,
      seq, heads);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long quads = (long long)batch * seq * heads * N / 4;
  const long long items = quads > (long long)heads * N ? quads : (long long)heads * N;
  wkv6_bwd_sum<<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dv_part), reinterpret_cast<float4*>(dv), du_part, du,
      quads, P::kSlices, batch, heads * N);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, dy and the outputs dr, dk, dv, dw: (batch, seq, heads, n) float32; u, du:
// (heads, n); state0: (batch, heads, n, n), the state the forward started from.  Scratch:
// ckpt batch * heads * ceil(seq / 16) * n * n floats, dv_part n / 16 * batch * seq * heads
// * n, du_part batch * heads * n.  n is 16, 32 or 64.
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* state0, const void* dy, void* ckpt,
                              void* dr, void* dk, void* dv, void* dw, void* du, void* dv_part,
                              void* du_part, int batch, int seq, int heads, int n, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1) return (int)cudaErrorInvalidValue;
#define REPRO_WKV6_BWD(NN)                                                                    \
  launch<NN>(static_cast<const float*>(r), static_cast<const float*>(k),                      \
             static_cast<const float*>(v), static_cast<const float*>(w),                      \
             static_cast<const float*>(u), static_cast<const float*>(state0),                 \
             static_cast<const float*>(dy), static_cast<float*>(ckpt), static_cast<float*>(dr), \
             static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dw),       \
             static_cast<float*>(du), static_cast<float*>(dv_part),                           \
             static_cast<float*>(du_part), batch, seq, heads, static_cast<cudaStream_t>(stream))
  switch (n) {
    case 16: return REPRO_WKV6_BWD(16);
    case 32: return REPRO_WKV6_BWD(32);
    case 64: return REPRO_WKV6_BWD(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_WKV6_BWD
}
