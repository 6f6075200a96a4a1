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
// block runs first.
//
// This is the CUDA-core design (float32, and bf16 at a D that the wgmma
// design of flash_prefill_bwd_wgmma.cu does not take, D % 8 == 0, D <=
// 256; kernel.py::bwd_design): the CUDA-core design of the forward
// (flash_prefill.cu:138), float32 arithmetic on bf16 or float32 loads,
// tiles staged in shared memory as float32 rows of D + 4 floats, 256
// threads as 16 x 16, a thread 4 x 4 scores and 4 rows of 4 J output
// columns (D <= 64 J); P and dS pass through shared memory.  The port's
// first version of this kernel; float32 training (the smoke configurations)
// runs on it.  bf16 at D in {64, 96, 128} ran on an mma.sync design of this
// file until the wgmma design replaced it; tools/time_flash_bwd_designs.py
// keeps it as text.
//
// Past D = 128 (gemma-7b's 256) four 64-row tiles of D + 4 floats no longer
// fit a block's 227 KB (266 KB at D = 256), so the key side of each launch
// takes tiles of kKeys = 32 keys instead of 64: the dQ block stages 64 query
// rows of Q and dO and 32 keys of K and V at a time (a thread 4 x 2 scores;
// 208 640 bytes at D = 256), the dK/dV block 32 keys of K and V and 64 query
// rows of Q and dO (a thread 2 x 4 scores and 2 rows of 4 J output columns
// of dK and of dV; 216 832 bytes).  Every sum keeps its fixed order; at D <=
// 128 the kernels are the 64-key ones, the same arithmetic in the same order.
//
// Float32 accumulation throughout; dq, dk and dv are rounded once to q's type.
//
// Bound on an H100: operations.  Five products of 2 S T D a (b, h) (halved
// where causal): at glm4-9b's training microbatch, B=2, H=32, S=T=4096,
// D=128, causal, 6.87e11 operations, 0.69 ms at the bf16 tensor-core peak
// of 989 TFLOP/s.  This design recomputes S in each launch (7 products, not
// 5) at the 67 TFLOP/s float32 rate, so it cannot come within 14x of that
// bound; it is held to the plain version beside the wgmma design on the card.
// At gemma-7b's training microbatch (B=2, H=16, S=T=4096, D=256, causal) the
// work is the same 6.87e11 operations and bound, 0.69 ms; this design is the
// only one there until a wgmma design splits D = 256 across warpgroups (a
// 64-key warpgroup's dK and dV would hold 256 float accumulators a thread,
// past setmaxnreg's 240).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query rows of a tile (and keys, up to D = 128)

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

// Stage rows r0 .. r0 + Rows - 1 of head `head` of a (B, rows, n_heads, D) tensor
// into dst[Rows][ld] as float32; rows at or past n_rows read as 0.
template <int Rows, typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x, int b, int r0, int head,
                                           int n_heads, int n_rows, int D, int ld, float* dst) {
  constexpr int E = 16 / sizeof(T);
  const int row_packs = D / E;
  for (int i = threadIdx.x; i < Rows * row_packs; i += kThreads) {
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
// over D, in order of d; I rows of a_s and c_s, Jn of b_s and d_s a thread.
template <int I, int Jn>
__device__ __forceinline__ void two_tile_dots(const float* a_s, const float* b_s, const float* c_s,
                                              const float* d_s, int D, int ld, int ty, int tx,
                                              float (&s)[I][Jn], float (&t)[I][Jn]) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < Jn; ++j) s[i][j] = t[i][j] = 0.0f;
  for (int d = 0; d < D; d += 4) {
    float4 a[I], b[Jn];
#pragma unroll
    for (int i = 0; i < I; ++i) a[i] = *reinterpret_cast<const float4*>(a_s + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < Jn; ++j) b[j] = *reinterpret_cast<const float4*>(b_s + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < Jn; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
#pragma unroll
    for (int i = 0; i < I; ++i) a[i] = *reinterpret_cast<const float4*>(c_s + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < Jn; ++j) b[j] = *reinterpret_cast<const float4*>(d_s + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < Jn; ++j) {
        t[i][j] = fmaf(a[i].x, b[j].x, t[i][j]);
        t[i][j] = fmaf(a[i].y, b[j].y, t[i][j]);
        t[i][j] = fmaf(a[i].z, b[j].z, t[i][j]);
        t[i][j] = fmaf(a[i].w, b[j].w, t[i][j]);
      }
  }
}

// acc[i][4 jj + e] += sum_r w_s[ty + 16 i][r] x_s[r][4 tx + 64 jj + e], r < R in order;
// w_s rows of stride Wld.
template <int I, int J, int R, int Wld>
__device__ __forceinline__ void tile_acc(const float* w_s, const float* x_s, int D, int ld, int ty,
                                         int tx, float (&acc)[I][4 * J]) {
  for (int r = 0; r < R; ++r) {
    float w[I];
#pragma unroll
    for (int i = 0; i < I; ++i) w[i] = w_s[(ty + 16 * i) * Wld + r];
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int d = 4 * tx + 64 * jj;
      if (d < D) {
        const float4 x = *reinterpret_cast<const float4*>(x_s + r * ld + d);
#pragma unroll
        for (int i = 0; i < I; ++i) {
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
template <typename T, int I, int J>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float (&acc)[I][4 * J],
                                           float mult, int b, int r0, int head, int n_heads,
                                           int n_rows, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < I; ++i) {
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

// Launch 1: a block a (query tile, query head, batch), query tiles longest first;
// K and V in tiles of Keys keys.
template <typename T, int J, int Keys>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, int S, int T_len, int H, int Hkv, int D,
          float scale, int causal) {
  constexpr int Jn = Keys / 16;  // keys of a thread's scores
  constexpr int kP = Keys + 1;   // row stride of the 64 x Keys tile of dS
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
  float* k_s = do_s + kTile * ld;    // [Keys][ld]
  float* v_s = k_s + Keys * ld;      // [Keys][ld]
  float* ds_s = v_s + Keys * ld;     // [64][kP]
  float* lse_s = ds_s + kTile * kP;  // [64]
  float* dl_s = lse_s + kTile;       // [64]

  stage_tile<kTile>(q, b, q0, h, H, S, D, ld, q_s);
  stage_tile<kTile>(dout, b, q0, h, H, S, D, ld, do_s);
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

  // key tiles up to the diagonal where causal (through key q0 + 63), else all
  // of T; never a tile that starts past T
  const int n_keys = (T_len + Keys - 1) / Keys;
  const int n_k = causal ? min((q0 + kTile + Keys - 1) / Keys, n_keys) : n_keys;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * Keys;
    __syncthreads();  // the previous tile's readers are done with k_s, v_s and ds_s
    stage_tile<Keys>(k, b, k0, kvh, Hkv, T_len, D, ld, k_s);
    stage_tile<Keys>(v, b, k0, kvh, Hkv, T_len, D, ld, v_s);
    __syncthreads();

    float s[4][Jn], dp[4][Jn];
    two_tile_dots<4, Jn>(q_s, k_s, do_s, v_s, D, ld, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < Jn; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool off = (causal && key > row) || key >= T_len || row >= S;
        const float p = off ? 0.0f : expf(fmaf(s[i][j], scale, -lse_s[r]));
        ds_s[r * kP + tx + 16 * j] = p * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();  // ds_s is complete
    tile_acc<4, J, Keys, kP>(ds_s, k_s, D, ld, ty, tx, acc);
  }
  store_rows<T, 4, J>(dq, acc, scale, b, q0, h, H, S, D, ty, tx);
}

// Launch 2: a block a (key tile of Keys keys, KV head, batch); where causal, key
// tile kt meets the query tiles from the one holding its first key on, so
// blockIdx.x = kt runs the longest first.
template <typename T, int J, int Keys>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S,
           int T_len, int H, int Hkv, int D, float scale, int causal) {
  constexpr int I = Keys / 16;    // keys of a thread's scores and output rows
  constexpr int kP = kTile + 1;   // row stride of the Keys x 64 tiles of P^T and dS^T
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = kt * Keys;
  const int ld = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // [Keys][ld]
  float* v_s = k_s + Keys * ld;      // [Keys][ld]
  float* q_s = v_s + Keys * ld;      // [64][ld]
  float* do_s = q_s + kTile * ld;    // [64][ld]
  float* p_s = do_s + kTile * ld;    // [Keys][kP]: P^T, a key a row
  float* ds_s = p_s + Keys * kP;     // [Keys][kP]: dS^T
  float* lse_s = ds_s + Keys * kP;   // [64]
  float* dl_s = lse_s + kTile;       // [64]

  stage_tile<Keys>(k, b, k0, kvh, Hkv, T_len, D, ld, k_s);
  stage_tile<Keys>(v, b, k0, kvh, Hkv, T_len, D, ld, v_s);

  float dk_acc[I][4 * J], dv_acc[I][4 * J];
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int c = 0; c < 4 * J; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  const int n_q = (S + kTile - 1) / kTile;
  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    for (int qt = causal ? k0 / kTile : 0; qt < n_q; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's readers are done with q_s, do_s, p_s and ds_s
      stage_tile<kTile>(q, b, q0, h, H, S, D, ld, q_s);
      stage_tile<kTile>(dout, b, q0, h, H, S, D, ld, do_s);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        const long long at = ((long long)b * H + h) * S + row;
        lse_s[threadIdx.x] = row < S ? lse[at] : 0.0f;
        dl_s[threadIdx.x] = row < S ? delta[at] : 0.0f;
      }
      __syncthreads();

      float s[I][4], dp[I][4];  // S^T and dP^T: a key a row, a query a column
      two_tile_dots<I, 4>(k_s, q_s, v_s, do_s, D, ld, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < I; ++i) {
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
      tile_acc<I, J, kTile, kP>(p_s, do_s, D, ld, ty, tx, dv_acc);
      tile_acc<I, J, kTile, kP>(ds_s, q_s, D, ld, ty, tx, dk_acc);
    }
  }
  store_rows<T, I, J>(dk, dk_acc, scale, b, k0, kvh, Hkv, T_len, D, ty, tx);
  store_rows<T, I, J>(dv, dv_acc, 1.0f, b, k0, kvh, Hkv, T_len, D, ty, tx);
}

size_t dq_smem(int D, int keys) {
  return sizeof(float) * (2 * (size_t)(kTile + keys) * (D + 4) + kTile * (keys + 1) + 2 * kTile);
}
size_t dkv_smem(int D, int keys) {
  return sizeof(float) *
         (2 * (size_t)(kTile + keys) * (D + 4) + 2 * keys * (kTile + 1) + 2 * kTile);
}

template <typename T, int J, int Keys>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int T_len,
           int H, int Hkv, int D, float scale, int causal, cudaStream_t stream) {
  const size_t s1 = dq_smem(D, Keys), s2 = dkv_smem(D, Keys);
  cudaError_t e = cudaFuncSetAttribute(dq_kernel<T, J, Keys>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dkv_kernel<T, J, Keys>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)s2);
  if (e != cudaSuccess) return (int)e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  dq_kernel<T, J, Keys><<<dim3((S + kTile - 1) / kTile, H, B), kThreads, s1, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dt, lse, delta, static_cast<T*>(dq), S, T_len, H,
      Hkv, D, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkv_kernel<T, J, Keys><<<dim3((T_len + Keys - 1) / Keys, Hkv, B), kThreads, s2, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, T_len, H, Hkv, D,
      scale, causal);
  return (int)cudaGetLastError();
}

// 64-key tiles up to D = 128; past it (D <= 256) 32-key tiles, so that a block's
// tiles fit its shared memory.
template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int T_len,
             int H, int Hkv, int D, float scale, int causal, cudaStream_t stream) {
#define REPRO_BWD(J, KEYS)                                                                  \
  launch<T, J, KEYS>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, T_len, H, Hkv, D, scale, \
                     causal, stream)
  if (D <= 64) return REPRO_BWD(1, 64);
  if (D <= 128) return REPRO_BWD(2, 64);
  if (D <= 192) return REPRO_BWD(3, 32);
  return REPRO_BWD(4, 32);
#undef REPRO_BWD
}

}  // namespace

// q, o, dout and dq (B, S, H, D); k, v, dk and dv (B, T, Hkv, D), all contiguous and of one
// type (is_bf16: bf16, else float32); lse (B, H, S) float32 from the forward; delta (B, H, S)
// float32 scratch that launch 1 writes and launch 2 reads.  D % 8 == 0 and D <= 256; causal
// needs T == S.
extern "C" int repro_flash_prefill_bwd(const void* q, const void* k, const void* v, const void* o,
                                       const void* dout, const void* lse, void* delta, void* dq,
                                       void* dk, void* dv, int B, int S, int T, int H, int Hkv,
                                       int D, float scale, int causal, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (T <= 0 || (causal && T != S) || D % 8 || D > 256 || H % Hkv)
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
