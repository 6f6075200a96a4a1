// Causal GQA flash attention over a whole prompt.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_prefill/kernel.py
// (prefill_kernel, launched by _grid_prefill).  That kernel runs a grid
// (B, H, q block, kv block) in order, carrying the online-softmax state
// across kv blocks in scratch memory; it skips kv blocks above the diagonal
// and masks only the one that straddles it.  Here a block owns one
// (batch, query head, 64-row query tile) and loops over the 64-key tiles up
// to the diagonal itself, so the state stays in registers:
//
//   * the query tile and one K (then V) tile are staged in shared memory as
//     float32, rows of D + 4 floats so that 16 lanes reading 16 rows with
//     float4 loads hit distinct banks;
//   * 256 threads as 16 x 16: thread (ty, tx) holds scores of rows
//     ty + 16i and keys tx + 16j (i, j < 4), and output columns
//     4 tx + 64 jj .. + 3 of its four rows; row max and row sum reduce over
//     the 16 lanes of a half-warp by shuffles;
//   * query head h reads KV head h / (H / Hkv), as the Pallas index map does:
//     no K/V replication;
//   * tiles above the diagonal are never visited; only the diagonal tile
//     masks (finite -1e30, so nothing is NaN); an S that is not a multiple
//     of 64 is handled here: rows at or past S read as 0 and are never
//     written, nothing is padded on the host;
//   * query tiles are scheduled longest first (the last tile sees S keys).
//
// Math in float32 on bf16 or f32 loads, on the CUDA cores; wgmma, TMA and
// pipelining are later work.  Bound on an H100: operations,
// 4 B H (S^2 / 2) D over the 989 TFLOP/s bf16 tensor-core peak: at glm4-9b,
// B=1, S=4096, 1.37e11 operations, 139 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query rows and keys of a tile
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Stage rows r0 .. r0 + 63 of head `head` of a (B, S, n_heads, D) tensor into dst[64][ld]
// as float32; rows at or past S read as 0.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x, int b, int r0, int head,
                                           int n_heads, int S, int D, int ld, float* dst) {
  constexpr int E = 16 / sizeof(T);
  const int row_packs = D / E;
  for (int i = threadIdx.x; i < kTile * row_packs; i += kThreads) {
    const int r = i / row_packs, c = (i % row_packs) * E;
    float* d = dst + r * ld + c;
    if (r0 + r < S) {
      load_pack(x + (((long long)b * S + r0 + r) * n_heads + head) * D + c, d);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = 0.0f;
    }
  }
}

// J = float4 output columns a thread holds per row: D <= 64 J.
template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ out, int S, int H, int Hkv, int D, float scale) {
  const int n_q = (S + kTile - 1) / kTile;
  const int qi = n_q - 1 - (int)blockIdx.x;  // longest query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = qi * kTile;
  const int ld = D + 4;
  constexpr int kP = kTile + 1;  // row stride of the probabilities
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // [64][ld]
  float* kv_s = q_s + kTile * ld;  // [64][ld]: K, then V, of one key tile
  float* p_s = kv_s + kTile * ld;  // [64][kP]

  stage_tile(q, b, q0, h, H, S, D, ld, q_s);

  float m[4], l[4], acc[4][4 * J];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * J; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = 0; kt <= qi; ++kt) {  // tiles above the diagonal are never visited
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done with kv_s and p_s
    stage_tile(k, b, k0, kvh, Hkv, S, D, ld, kv_s);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(kv_s + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

    const bool diag = kt == qi;  // the tile that straddles the diagonal: mask it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (diag && k0 + tx + 16 * j > row) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(ty + 16 * i) * kP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * J; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every thread is done reading K; p_s is complete
    stage_tile(v, b, k0, kvh, Hkv, S, D, ld, kv_s);
    __syncthreads();

    for (int r = 0; r < kTile; ++r) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty + 16 * i) * kP + r];
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const int d = 4 * tx + 64 * jj;
        if (d < D) {
          const float4 w = *reinterpret_cast<const float4*>(kv_s + r * ld + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * jj + 0] = fmaf(p[i], w.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(p[i], w.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(p[i], w.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(p[i], w.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;  // rows past a ragged S are never written
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = out + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int d = 4 * tx + 64 * jj;
      if (d < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(dst + d + e, acc[i][4 * jj + e] / denom);
      }
    }
  }
}

template <typename T, int J>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int Hkv,
           int D, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)kTile * (D + 4) + (size_t)kTile * (kTile + 1));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_kernel<T, J>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_q = (S + kTile - 1) / kTile;
  prefill_kernel<T, J><<<dim3(n_q, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, Hkv, D, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
             int Hkv, int D, float scale, cudaStream_t stream) {
  if (D <= 64) return launch<T, 1>(q, k, v, out, B, S, H, Hkv, D, scale, stream);
  if (D <= 128) return launch<T, 2>(q, k, v, out, B, S, H, Hkv, D, scale, stream);
  return launch<T, 4>(q, k, v, out, B, S, H, Hkv, D, scale, stream);
}

}  // namespace

// q (B, S, H, D), k and v (B, S, Hkv, D), out (B, S, H, D), all contiguous and of one type
// (is_bf16: bf16, else float32).  D % 8 == 0 and D <= 256.
extern "C" int repro_flash_prefill(const void* q, const void* k, const void* v, void* out, int B,
                                   int S, int H, int Hkv, int D, float scale, int is_bf16,
                                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_d<__nv_bfloat16>(q, k, v, out, B, S, H, Hkv, D, scale, st);
  return launch_d<float>(q, k, v, out, B, S, H, Hkv, D, scale, st);
}
