// The gradient of GQA flash attention, causal or not: dQ, dK and dV in two launches.
//
// Replaces no Pallas kernel: the reference trains through JAX's autodiff of
// its jnp flash_attention (src/repro/models/attention.py:67-159; the Pallas
// prefill_kernel, src/repro/kernels/flash_prefill/kernel.py:29, has no
// backward and is off in training).  This is the training form of that row:
// the gradient of what flash_prefill.cu computes, from q, k, v, its output o,
// the output's gradient dO and the float32 log-sum-exp of each row that the
// forward saved (flash_prefill.cu's lse), by the textbook formulas:
//
//   P = exp(Q K^T / sqrt(D) - lse),  dV = P^T dO,  dP = dO V^T,
//   delta_i = sum_d dO_id O_id,  dS = P (dP - delta),
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),
//
// with P = 0 above the diagonal (causal) and past a ragged S or T.  GQA: the
// g = H / Hkv query heads of a KV head add into its dK and dV.
//
// Two launches, and no atomics, so two runs give the same bits:
//   1. dq_kernel, a block a (64-row query tile, query head, batch): delta of
//      its rows (written for launch 2), then every key tile up to the
//      diagonal (all of T where not causal) in order: S and dP, dS, and
//      dQ += dS K;
//   2. dkv_kernel, a block a (64-key tile, KV head, batch): its g query heads
//      in order, and for each every query tile from the diagonal on in
//      order: S^T and dP^T, then dV += P^T dO and dK += dS^T Q, in registers.
// The order of every sum is fixed by the loops; nothing depends on which
// block runs first.  Two designs, chosen by dtype and D alone
// (kernel.py::bwd_design):
//
// repro_flash_prefill_bwd_mma (bf16, D in {64, 96, 128}; namespace tc): the
//   products on the tensor cores, mma.sync m16n8k16 bf16 with float32
//   accumulators, 4 warps a block.  A dQ block's warp owns 16 query rows,
//   a dK/dV block's warp 16 keys (query tiles of 32 rows there, so that dK,
//   dV, S^T and dP^T fit 238 registers at D = 128).  Tiles are staged as
//   bf16 rows of D + 8 (16-byte loads; the padding spreads ldmatrix's rows
//   over the banks); A fragments and B fragments come by ldmatrix, the
//   products' second operands that must be read transposed (K in dS K, dO
//   in P^T dO, Q in dS^T Q) by ldmatrix.trans, so nothing is transposed in
//   shared memory; P and dS never leave registers: a 16 x 8 accumulator's
//   C fragments are the next product's A fragment once rounded to bf16.
//   Rounding P and dS to bf16 there moved glm4-9b's attention weights'
//   gradients no further from the plain version's than the CUDA-core design
//   did (chip_smoke.py phase 28 (c)), and P and dS each split into bf16
//   hi + lo bought nothing for 12% more time, so neither is split.
//
// repro_flash_prefill_bwd (float32, and bf16 at any other D % 8 == 0, D <=
//   128): the CUDA-core design of the forward (flash_prefill.cu:138):
//   float32 arithmetic on bf16 or float32 loads, tiles staged in shared
//   memory as float32 rows of D + 4 floats, 256 threads as 16 x 16, a
//   thread 4 x 4 scores and 4 rows of 4 J output columns (D <= 64 J); P and
//   dS pass through shared memory.  The port's first version of this
//   kernel; float32 training (the smoke configurations) runs on it.
//
// Float32 accumulation throughout; dq, dk and dv are rounded once to q's type.
//
// Bound on an H100: operations.  Five products of 2 S T D a (b, h) (halved
// where causal) over the bf16 tensor-core peak of 989 TFLOP/s: at glm4-9b's
// training microbatch, B=2, H=32, S=T=4096, D=128, causal, 6.87e11
// operations, 0.69 ms.  Both designs recompute S in each launch (7
// products, not 5); the CUDA-core one runs them at the 67 TFLOP/s float32
// rate, so it cannot come within 14x of that bound.  The mma design's dK/dV
// launch has one block a 64-key tile: at glm4-9b that is 256 blocks, the
// first key tiles walking all 4096 query rows of 16 heads, so the longest
// blocks set its time.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;      // query rows and keys of a tile
constexpr int kP = kTile + 1;  // row stride of a 64 x 64 tile of P or dS

__device__ __forceinline__ void load_pack(const float* __restrict__ src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void load_pack(const __nv_bfloat16* __restrict__ src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Stage rows r0 .. r0 + 63 of head `head` of a (B, rows, n_heads, D) tensor into
// dst[64][ld] as float32; rows at or past n_rows read as 0.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x, int b, int r0, int head,
                                           int n_heads, int n_rows, int D, int ld, float* dst) {
  constexpr int E = 16 / sizeof(T);
  const int row_packs = D / E;
  for (int i = threadIdx.x; i < kTile * row_packs; i += kThreads) {
    const int r = i / row_packs, c = (i % row_packs) * E;
    float* d = dst + r * ld + c;
    if (r0 + r < n_rows) {
      load_pack(x + (((long long)b * n_rows + r0 + r) * n_heads + head) * D + c, d);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = 0.0f;
    }
  }
}

// s[i][j] = a_s[ty + 16 i] . b_s[tx + 16 j] and t[i][j] = c_s[ty + 16 i] . d_s[tx + 16 j],
// over D, in order of d.
__device__ __forceinline__ void two_tile_dots(const float* a_s, const float* b_s, const float* c_s,
                                              const float* d_s, int D, int ld, int ty, int tx,
                                              float (&s)[4][4], float (&t)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.0f;
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(a_s + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(b_s + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(c_s + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(d_s + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t[i][j] = fmaf(a[i].x, b[j].x, t[i][j]);
        t[i][j] = fmaf(a[i].y, b[j].y, t[i][j]);
        t[i][j] = fmaf(a[i].z, b[j].z, t[i][j]);
        t[i][j] = fmaf(a[i].w, b[j].w, t[i][j]);
      }
  }
}

// acc[i][4 jj + e] += sum_r w_s[ty + 16 i][r] x_s[r][4 tx + 64 jj + e], r in order.
template <int J>
__device__ __forceinline__ void tile_acc(const float* w_s, const float* x_s, int D, int ld, int ty,
                                         int tx, float (&acc)[4][4 * J]) {
  for (int r = 0; r < kTile; ++r) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = w_s[(ty + 16 * i) * kP + r];
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int d = 4 * tx + 64 * jj;
      if (d < D) {
        const float4 x = *reinterpret_cast<const float4*>(x_s + r * ld + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * jj + 0] = fmaf(w[i], x.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(w[i], x.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(w[i], x.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(w[i], x.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

// Write rows r0 + ty + 16 i (below n_rows) of acc * mult into head `head` of a
// (B, n_rows, n_heads, D) tensor.
template <typename T, int J>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float (&acc)[4][4 * J],
                                           float mult, int b, int r0, int head, int n_heads,
                                           int n_rows, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n_rows) continue;
    T* dst = out + (((long long)b * n_rows + row) * n_heads + head) * D;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int d = 4 * tx + 64 * jj;
      if (d < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(dst + d + e, acc[i][4 * jj + e] * mult);
      }
    }
  }
}

// Launch 1: a block a (query tile, query head, batch), query tiles longest first.
template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, int S, int T_len, int H, int Hkv, int D,
          float scale, int causal) {
  const int n_q = (S + kTile - 1) / kTile;
  const int qi = n_q - 1 - (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = qi * kTile;
  const int ld = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [64][ld]
  float* do_s = q_s + kTile * ld;    // [64][ld]
  float* k_s = do_s + kTile * ld;    // [64][ld]
  float* v_s = k_s + kTile * ld;     // [64][ld]
  float* ds_s = v_s + kTile * ld;    // [64][kP]
  float* lse_s = ds_s + kTile * kP;  // [64]
  float* dl_s = lse_s + kTile;       // [64]

  stage_tile(q, b, q0, h, H, S, D, ld, q_s);
  stage_tile(dout, b, q0, h, H, S, D, ld, do_s);
  __syncthreads();

  // delta of the tile's rows: 4 threads a row, each a quarter of the columns
  // in order, then two shuffles in a fixed order
  {
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3, row = q0 + r;
    float sum = 0.0f;
    if (row < S) {
      const T* orow = o + (((long long)b * S + row) * H + h) * D;
      for (int d = part; d < D; d += 4) sum = fmaf(do_s[r * ld + d], to_float(orow[d]), sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      const long long at = ((long long)b * H + h) * S + row;
      dl_s[r] = sum;
      lse_s[r] = row < S ? lse[at] : 0.0f;
      if (row < S) delta[at] = sum;
    }
  }

  float acc[4][4 * J];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * J; ++c) acc[i][c] = 0.0f;

  const int n_k = causal ? qi + 1 : (T_len + kTile - 1) / kTile;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done with k_s, v_s and ds_s
    stage_tile(k, b, k0, kvh, Hkv, T_len, D, ld, k_s);
    stage_tile(v, b, k0, kvh, Hkv, T_len, D, ld, v_s);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_tile_dots(q_s, k_s, do_s, v_s, D, ld, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool off = (causal && key > row) || key >= T_len || row >= S;
        const float p = off ? 0.0f : expf(fmaf(s[i][j], scale, -lse_s[r]));
        ds_s[r * kP + tx + 16 * j] = p * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();  // ds_s is complete
    tile_acc<J>(ds_s, k_s, D, ld, ty, tx, acc);
  }
  store_rows<T, J>(dq, acc, scale, b, q0, h, H, S, D, ty, tx);
}

// Launch 2: a block a (key tile, KV head, batch); where causal, key tile kt
// meets n_q - kt query tiles, so blockIdx.x = kt runs the longest first.
template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S,
           int T_len, int H, int Hkv, int D, float scale, int causal) {
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = kt * kTile;
  const int ld = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // [64][ld]
  float* v_s = k_s + kTile * ld;     // [64][ld]
  float* q_s = v_s + kTile * ld;     // [64][ld]
  float* do_s = q_s + kTile * ld;    // [64][ld]
  float* p_s = do_s + kTile * ld;    // [64][kP]: P^T, a key a row
  float* ds_s = p_s + kTile * kP;    // [64][kP]: dS^T
  float* lse_s = ds_s + kTile * kP;  // [64]
  float* dl_s = lse_s + kTile;       // [64]

  stage_tile(k, b, k0, kvh, Hkv, T_len, D, ld, k_s);
  stage_tile(v, b, k0, kvh, Hkv, T_len, D, ld, v_s);

  float dk_acc[4][4 * J], dv_acc[4][4 * J];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * J; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  const int n_q = (S + kTile - 1) / kTile;
  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    for (int qt = causal ? kt : 0; qt < n_q; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's readers are done with q_s, do_s, p_s and ds_s
      stage_tile(q, b, q0, h, H, S, D, ld, q_s);
      stage_tile(dout, b, q0, h, H, S, D, ld, do_s);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        const long long at = ((long long)b * H + h) * S + row;
        lse_s[threadIdx.x] = row < S ? lse[at] : 0.0f;
        dl_s[threadIdx.x] = row < S ? delta[at] : 0.0f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];  // S^T and dP^T: a key a row, a query a column
      two_tile_dots(k_s, q_s, v_s, do_s, D, ld, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, key = k0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, row = q0 + c;
          const bool off = (causal && key > row) || key >= T_len || row >= S;
          const float p = off ? 0.0f : expf(fmaf(s[i][j], scale, -lse_s[c]));
          p_s[r * kP + c] = p;
          ds_s[r * kP + c] = p * (dp[i][j] - dl_s[c]);
        }
      }
      __syncthreads();  // p_s and ds_s are complete
      tile_acc<J>(p_s, do_s, D, ld, ty, tx, dv_acc);
      tile_acc<J>(ds_s, q_s, D, ld, ty, tx, dk_acc);
    }
  }
  store_rows<T, J>(dk, dk_acc, scale, b, k0, kvh, Hkv, T_len, D, ty, tx);
  store_rows<T, J>(dv, dv_acc, 1.0f, b, k0, kvh, Hkv, T_len, D, ty, tx);
}

size_t dq_smem(int D) {
  return sizeof(float) * (4 * (size_t)kTile * (D + 4) + kTile * kP + 2 * kTile);
}
size_t dkv_smem(int D) {
  return sizeof(float) * (4 * (size_t)kTile * (D + 4) + 2 * kTile * kP + 2 * kTile);
}

template <typename T, int J>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int T_len,
           int H, int Hkv, int D, float scale, int causal, cudaStream_t stream) {
  const size_t s1 = dq_smem(D), s2 = dkv_smem(D);
  cudaError_t e = cudaFuncSetAttribute(dq_kernel<T, J>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dkv_kernel<T, J>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (e != cudaSuccess) return (int)e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  dq_kernel<T, J><<<dim3((S + kTile - 1) / kTile, H, B), kThreads, s1, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dt, lse, delta, static_cast<T*>(dq), S, T_len, H,
      Hkv, D, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkv_kernel<T, J><<<dim3((T_len + kTile - 1) / kTile, Hkv, B), kThreads, s2, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, T_len, H, Hkv, D,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int T_len,
             int H, int Hkv, int D, float scale, int causal, cudaStream_t stream) {
#define REPRO_BWD(J)                                                                        \
  launch<T, J>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, T_len, H, Hkv, D, scale, causal, \
               stream)
  if (D <= 64) return REPRO_BWD(1);
  return REPRO_BWD(2);
#undef REPRO_BWD
}

}  // namespace

// q, o, dout and dq (B, S, H, D); k, v, dk and dv (B, T, Hkv, D), all contiguous and of one
// type (is_bf16: bf16, else float32); lse (B, H, S) float32 from the forward; delta (B, H, S)
// float32 scratch that launch 1 writes and launch 2 reads.  D % 8 == 0 and D <= 128; causal
// needs T == S.
extern "C" int repro_flash_prefill_bwd(const void* q, const void* k, const void* v, const void* o,
                                       const void* dout, const void* lse, void* delta, void* dq,
                                       void* dk, void* dv, int B, int S, int T, int H, int Hkv,
                                       int D, float scale, int causal, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (T <= 0 || (causal && T != S) || D % 8 || D > 128 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, T, H, Hkv, D, scale,
                                   causal, st);
  return launch_d<float>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, T, H, Hkv, D, scale, causal,
                         st);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16, P and dS kept in registers.

namespace tc {

constexpr int kThreads = 128;  // 4 warps
constexpr int kKeys = 64;      // keys of a dK/dV block, 16 a warp; keys of a dQ step
constexpr int kRows = 64;      // query rows of a dQ block, 16 a warp
constexpr int kQ = 32;         // query rows of a dK/dV step

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory, each lane one row address.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Lane addresses (in a tile of rows of LD bf16) of the three fragment loads:
// A rows m0.. m0 + 15, columns k0.. k0 + 15; B of two 8-column blocks n0, n0 + 8
// from a tile stored n by k (non-trans) or k by n (trans).
__device__ __forceinline__ int a_at(int lane, int m0, int k0, int ld) {
  return (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_at(int lane, int n0, int k0, int ld) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bt_at(int lane, int k0, int n0, int ld) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
}

// Rows r0 .. r0 + n - 1 of head `head` of a (B, n_rows, n_heads, D) bf16 tensor into
// dst[n][D + 8], 16 bytes a thread; rows at or past n_rows are zeros.
template <int D>
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ x, int b, int r0,
                                      int head, int n_heads, int n_rows, int n,
                                      __nv_bfloat16* dst) {
  constexpr int P = D / 8;
  for (int i = threadIdx.x; i < n * P; i += kThreads) {
    const int r = i / P, c = (i % P) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows)
      v = *reinterpret_cast<const uint4*>(
          x + (((long long)b * n_rows + r0 + r) * n_heads + head) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = v;
  }
}

// The A fragment of a 16 x 16 block of a 16-row accumulator, from the C
// fragments of its two 8-column blocks (the layouts line up), rounded to bf16.
__device__ __forceinline__ void to_a(const float (&c0)[4], const float (&c1)[4], uint32_t (&a)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Launch 1: a block a (64-row query tile, query head, batch), a warp 16 rows.
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S, int T, int H,
          int Hkv, float scale, int causal) {
  constexpr int LD = D + 8;
  const int n_q = (S + kRows - 1) / kRows;
  const int qi = n_q - 1 - (int)blockIdx.x;  // longest query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int q0 = qi * kRows;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  extern __shared__ __align__(16) __nv_bfloat16 tiles[];
  __nv_bfloat16* q_s = tiles;
  __nv_bfloat16* do_s = q_s + kRows * LD;
  __nv_bfloat16* k_s = do_s + kRows * LD;
  __nv_bfloat16* v_s = k_s + kKeys * LD;
  float* dl_s = reinterpret_cast<float*>(v_s + kKeys * LD);

  stage<D>(q, b, q0, h, H, S, kRows, q_s);
  stage<D>(dout, b, q0, h, H, S, kRows, do_s);
  __syncthreads();
  {  // delta of the tile's rows: 2 threads a row, each half the columns in order
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    float sum = 0.0f;
    if (row < S) {
      const __nv_bfloat16* orow = o + (((long long)b * S + row) * H + h) * D;
      for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d)
        sum = fmaf(__bfloat162float(do_s[r * LD + d]), __bfloat162float(orow[d]), sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      dl_s[r] = sum;
      if (row < S) delta[((long long)b * H + h) * S + row] = sum;
    }
  }
  __syncthreads();
  const int m0 = 16 * w;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + m0 + g + 8 * i;
    lse_r[i] = row < S ? lse[((long long)b * H + h) * S + row] : 0.0f;
    dl_r[i] = dl_s[m0 + g + 8 * i];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  const int n_k = causal ? qi + 1 : (T + kKeys - 1) / kKeys;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous step's readers are done with k_s and v_s
    stage<D>(k, b, k0, kvh, Hkv, T, kKeys, k_s);
    stage<D>(v, b, k0, kvh, Hkv, T, kKeys, v_s);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      ldsm(aq, smem_u32(q_s + a_at(lane, m0, 16 * kk, LD)));
      ldsm(ado, smem_u32(do_s + a_at(lane, m0, 16 * kk, LD)));
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t bk[4], bv[4];
        ldsm(bk, smem_u32(k_s + b_at(lane, 16 * nb, 16 * kk, LD)));
        ldsm(bv, smem_u32(v_s + b_at(lane, 16 * nb, 16 * kk, LD)));
        mma(s[2 * nb], aq, bk[0], bk[1]);
        mma(s[2 * nb + 1], aq, bk[2], bk[3]);
        mma(dp[2 * nb], ado, bv[0], bv[1]);
        mma(dp[2 * nb + 1], ado, bv[2], bv[3]);
      }
    }
    // dS = P (dP - delta), P = exp(S / sqrt(D) - lse), 0 where masked
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + m0 + g + 8 * (e >> 1), key = k0 + 8 * j + 2 * t + (e & 1);
        const bool off = (causal && key > row) || key >= T || row >= S;
        const float p = off ? 0.0f : expf(fmaf(s[j][e], scale, -lse_r[e >> 1]));
        s[j][e] = p * (dp[j][e] - dl_r[e >> 1]);
      }
    // dQ += dS K: the keys are the products' depth, K (keys by D) read transposed
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[4];
      to_a(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
      for (int nb = 0; nb < D / 16; ++nb) {
        uint32_t bk[4];
        ldsm_t(bk, smem_u32(k_s + bt_at(lane, 16 * kk, 16 * nb, LD)));
        mma(acc[2 * nb], a, bk[0], bk[1]);
        mma(acc[2 * nb + 1], a, bk[2], bk[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + m0 + g + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* dst = dq + (((long long)b * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

// Launch 2: a block a (64-key tile, KV head, batch), a warp 16 keys; its g query
// heads in order, and for each the 32-row query tiles from the diagonal on in order.
template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int T, int H,
           int Hkv, float scale, int causal) {
  constexpr int LD = D + 8;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g_heads = H / Hkv;
  const int k0 = kt * kKeys;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  extern __shared__ __align__(16) __nv_bfloat16 tiles[];
  __nv_bfloat16* k_s = tiles;
  __nv_bfloat16* v_s = k_s + kKeys * LD;
  __nv_bfloat16* q_s = v_s + kKeys * LD;
  __nv_bfloat16* do_s = q_s + kQ * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + kQ * LD);
  float* dl_s = lse_s + kQ;

  stage<D>(k, b, k0, kvh, Hkv, T, kKeys, k_s);
  stage<D>(v, b, k0, kvh, Hkv, T, kKeys, v_s);
  const int m0 = 16 * w;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;

  const int n_q = (S + kQ - 1) / kQ;
  for (int hh = 0; hh < g_heads; ++hh) {
    const int h = kvh * g_heads + hh;
    for (int qt = causal ? k0 / kQ : 0; qt < n_q; ++qt) {
      const int q0 = qt * kQ;
      __syncthreads();  // the previous step's readers are done with q_s, do_s, lse_s, dl_s
      stage<D>(q, b, q0, h, H, S, kQ, q_s);
      stage<D>(dout, b, q0, h, H, S, kQ, do_s);
      if (threadIdx.x < kQ) {
        const int row = q0 + threadIdx.x;
        const long long at = ((long long)b * H + h) * S + row;
        lse_s[threadIdx.x] = row < S ? lse[at] : 0.0f;
        dl_s[threadIdx.x] = row < S ? delta[at] : 0.0f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: a key a row, a query a column
      float s[kQ / 8][4], dp[kQ / 8][4];
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        ldsm(ak, smem_u32(k_s + a_at(lane, m0, 16 * kk, LD)));
        ldsm(av, smem_u32(v_s + a_at(lane, m0, 16 * kk, LD)));
#pragma unroll
        for (int nb = 0; nb < kQ / 16; ++nb) {
          uint32_t bq[4], bo[4];
          ldsm(bq, smem_u32(q_s + b_at(lane, 16 * nb, 16 * kk, LD)));
          ldsm(bo, smem_u32(do_s + b_at(lane, 16 * nb, 16 * kk, LD)));
          mma(s[2 * nb], ak, bq[0], bq[1]);
          mma(s[2 * nb + 1], ak, bq[2], bq[3]);
          mma(dp[2 * nb], av, bo[0], bo[1]);
          mma(dp[2 * nb + 1], av, bo[2], bo[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + m0 + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1), row = q0 + c;
          const bool off = (causal && key > row) || key >= T || row >= S;
          const float p = off ? 0.0f : expf(fmaf(s[j][e], scale, -lse_s[c]));
          dp[j][e] = p * (dp[j][e] - dl_s[c]);  // dS^T
          s[j][e] = p;                          // P^T
        }
      // dV += P^T dO and dK += dS^T Q: the queries are the depth, dO and Q read transposed
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        uint32_t ap[4], ads[4];
        to_a(s[2 * kk], s[2 * kk + 1], ap);
        to_a(dp[2 * kk], dp[2 * kk + 1], ads);
#pragma unroll
        for (int nb = 0; nb < D / 16; ++nb) {
          uint32_t bo[4], bq[4];
          ldsm_t(bo, smem_u32(do_s + bt_at(lane, 16 * kk, 16 * nb, LD)));
          ldsm_t(bq, smem_u32(q_s + bt_at(lane, 16 * kk, 16 * nb, LD)));
          mma(dv_acc[2 * nb], ap, bo[0], bo[1]);
          mma(dv_acc[2 * nb + 1], ap, bo[2], bo[3]);
          mma(dk_acc[2 * nb], ads, bq[0], bq[1]);
          mma(dk_acc[2 * nb + 1], ads, bq[2], bq[3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + m0 + g + 8 * i;
    if (key >= T) continue;
    const long long at = (((long long)b * T + key) * Hkv + kvh) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(dk_acc[j][2 * i] * scale, dk_acc[j][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int T,
           int H, int Hkv, float scale, int causal, cudaStream_t stream) {
  const size_t s1 = 2 * (size_t)(2 * kRows + 2 * kKeys) * (D + 8) + 4 * kRows;
  const size_t s2 = 2 * (size_t)(2 * kKeys + 2 * kQ) * (D + 8) + 8 * kQ;
  cudaError_t e =
      cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (e != cudaSuccess) return (int)e;
  using bf = __nv_bfloat16;
  const bf* qb = static_cast<const bf*>(q);
  const bf* kb = static_cast<const bf*>(k);
  const bf* vb = static_cast<const bf*>(v);
  const bf* db = static_cast<const bf*>(dout);
  dq_kernel<D><<<dim3((S + kRows - 1) / kRows, H, B), kThreads, s1, stream>>>(
      qb, kb, vb, static_cast<const bf*>(o), db, lse, delta, static_cast<bf*>(dq), S, T, H, Hkv,
      scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkv_kernel<D><<<dim3((T + kKeys - 1) / kKeys, Hkv, B), kThreads, s2, stream>>>(
      qb, kb, vb, db, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), S, T, H, Hkv, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

// bf16 q, o, dout and dq (B, S, H, D), k, v, dk and dv (B, T, Hkv, D), contiguous; lse
// and delta as for repro_flash_prefill_bwd; D in {64, 96, 128}; causal needs T == S.
extern "C" int repro_flash_prefill_bwd_mma(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const void* lse,
                                           void* delta, void* dq, void* dk, void* dv, int B, int S,
                                           int T, int H, int Hkv, int D, float scale, int causal,
                                           void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (T <= 0 || (causal && T != S) || H % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define REPRO_TC(DIM) \
  tc::launch<DIM>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, T, H, Hkv, scale, causal, st)
  switch (D) {
    case 64: return REPRO_TC(64);
    case 96: return REPRO_TC(96);
    case 128: return REPRO_TC(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_TC
}
