// GQA flash-decode: one query token per sequence attends over a padded KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py
// (decode_kernel, launched by _grid_decode).  That kernel walks the whole
// cache in order on one core, carrying the online-softmax state (m, l, acc)
// across S blocks in scratch memory, and masks positions at or past each
// sequence's length.  Hopper runs blocks in parallel and in no order, and a
// grid of (batch, KV head) alone is 16 blocks at glm4-9b's B=8, Hkv=2 on
// 132 SMs, so the cache is split along S as well (flash-decoding):
//
//   pass 1, grid (split, KV head, batch): a block streams its split of the
//     cache in tiles of 64 positions through shared memory, once for the
//     whole q-group of its KV head (16 queries at glm4-9b, 5 at qwen3-14b,
//     1 at gemma-7b; any group), and writes its (m, l, acc) partials.
//     Splits and tiles at or past the sequence's length are skipped, not
//     streamed and masked; only the last tile masks, with the finite -1e30
//     of the Pallas kernel, so no score is ever -inf and nothing is NaN.
//   pass 2, grid (head, batch): combines the valid splits in a fixed order
//     and divides by max(l, 1e-30), as the Pallas finalize does.
//
// No atomics: two runs agree bit for bit.  Math in float32 on bf16 or f32
// loads (CUDA cores; wgmma, TMA and pipelining are later work).  Bound on an
// H100 (3.35 TB/s): bytes, K and V of the valid positions read once: at
// glm4-9b, B=8, S=32 768, bf16, 268 MB, 80 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;    // cache positions staged in shared memory per step
constexpr int kMaxPacks = 4; // float4 accumulators a thread holds: group * D <= 4096
constexpr float kNegInf = -1e30f;

// Widen one 16-byte pack (4 floats or 8 bf16) at src into float dst (16-byte aligned).
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

template <typename T> struct Pack { static constexpr int kElems = 16 / sizeof(T); };

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, int H, int Hkv, int D, long long S,
                    int n_splits, long long split_len, float scale, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc) {
  constexpr int E = Pack<T>::kElems;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const long long len = min((long long)lengths[b], S);
  const long long s_begin = (long long)split * split_len;
  if (s_begin >= len) return;  // past this sequence's length: pass 2 reads no partial here
  const long long s_end = min(s_begin + split_len, len);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = D + 4;  // row stride of the K/V tiles: float4 rows land on distinct banks
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [g][D]
  float* k_s = q_s + g * D;          // [kTile][ld]
  float* v_s = k_s + kTile * ld;     // [kTile][ld]
  float* p_s = v_s + kTile * ld;     // [g][kTile]
  float* m_s = p_s + g * kTile;      // [g] running max
  float* l_s = m_s + g;              // [g] running denominator
  float* a_s = l_s + g;              // [g] rescale of this tile

  // the group's queries are g adjacent heads: one contiguous run of g * D
  const T* qg = q + ((long long)b * H + (long long)kvh * g) * D;
  for (int i = tid; i < g * D / E; i += kThreads) load_pack(qg + i * E, q_s + i * E);
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }
  const int gd4 = g * D / 4;  // float4 packs of the (g, D) accumulator
  float acc[kMaxPacks][4];
#pragma unroll
  for (int j = 0; j < kMaxPacks; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  const int row_packs = D / E;
  for (long long t0 = s_begin; t0 < s_end; t0 += kTile) {
    const int rows = (int)min((long long)kTile, s_end - t0);
    // stage K and V of positions t0 .. t0 + rows - 1; the rest of the tile reads as 0
    for (int i = tid; i < kTile * row_packs; i += kThreads) {
      const int r = i / row_packs, c = (i % row_packs) * E;
      float* kd = k_s + r * ld + c;
      float* vd = v_s + r * ld + c;
      if (r < rows) {
        const long long off = (((long long)b * S + t0 + r) * Hkv + kvh) * D + c;
        load_pack(k + off, kd);
        load_pack(v + off, vd);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kd[e] = vd[e] = 0.0f;
      }
    }
    __syncthreads();

    // scores: lanes take consecutive positions of one query row
    for (int i = tid; i < g * kTile; i += kThreads) {
      const int gi = i / kTile, r = i % kTile;
      const float* qr = q_s + gi * D;
      const float* kr = k_s + r * ld;
      float dot = 0.0f;
      for (int d = 0; d < D; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qr + d);
        const float4 c = *reinterpret_cast<const float4*>(kr + d);
        dot = fmaf(a.x, c.x, dot);
        dot = fmaf(a.y, c.y, dot);
        dot = fmaf(a.z, c.z, dot);
        dot = fmaf(a.w, c.w, dot);
      }
      p_s[i] = r < rows ? dot * scale : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int gi = warp; gi < g; gi += kWarps) {
      float* pr = p_s + gi * kTile;
      float mx = kNegInf;
      for (int r = lane; r < kTile; r += 32) mx = fmaxf(mx, pr[r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int r = lane; r < kTile; r += 32) {
        const float e = expf(pr[r] - m_new);
        pr[r] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[gi] = alpha;
        l_s[gi] = alpha * l_s[gi] + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + p @ v, four output columns a thread per pack
#pragma unroll
    for (int j = 0; j < kMaxPacks; ++j) {
      const int e4 = tid + j * kThreads;
      if (e4 < gd4) {
        const int gi = (e4 * 4) / D, d = (e4 * 4) % D;
        const float* pr = p_s + gi * kTile;
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
        for (int r = 0; r < rows; ++r) {
          const float p = pr[r];
          const float4 w = *reinterpret_cast<const float4*>(v_s + r * ld + d);
          s0 = fmaf(p, w.x, s0);
          s1 = fmaf(p, w.y, s1);
          s2 = fmaf(p, w.z, s2);
          s3 = fmaf(p, w.w, s3);
        }
        const float alpha = a_s[gi];
        acc[j][0] = alpha * acc[j][0] + s0;
        acc[j][1] = alpha * acc[j][1] + s1;
        acc[j][2] = alpha * acc[j][2] + s2;
        acc[j][3] = alpha * acc[j][3] + s3;
      }
    }
    __syncthreads();
  }

  // partials of head kvh * g + gi at split `split`
  const long long head0 = (long long)b * H + (long long)kvh * g;
  for (int gi = tid; gi < g; gi += kThreads) {
    part_m[(head0 + gi) * n_splits + split] = m_s[gi];
    part_l[(head0 + gi) * n_splits + split] = l_s[gi];
  }
#pragma unroll
  for (int j = 0; j < kMaxPacks; ++j) {
    const int e4 = tid + j * kThreads;
    if (e4 < gd4) {
      const int gi = (e4 * 4) / D, d = (e4 * 4) % D;
      float* dst = part_acc + ((head0 + gi) * n_splits + split) * D + d;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
  }
}

template <typename T>
__global__ void decode_combine_kernel(const int* __restrict__ lengths, int H, int D, long long S,
                                      int n_splits, long long split_len,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc, T* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y;
  const long long len = min((long long)lengths[b], S);
  const int n_valid = len <= 0 ? 0 : (int)min((long long)n_splits, (len + split_len - 1) / split_len);
  const long long base = ((long long)b * H + h) * n_splits;
  float m = kNegInf;
  for (int s = 0; s < n_valid; ++s) m = fmaxf(m, part_m[base + s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float l = 0.0f, o = 0.0f;
    for (int s = 0; s < n_valid; ++s) {
      const float w = expf(part_m[base + s] - m);
      l = fmaf(w, part_l[base + s], l);
      o = fmaf(w, part_acc[(base + s) * D + d], o);
    }
    store(out + ((long long)b * H + h) * D + d, o / fmaxf(l, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths, int B, int H,
           int Hkv, int D, long long S, int n_splits, long long split_len, float scale,
           void* part_m, void* part_l, void* part_acc, void* out, cudaStream_t stream) {
  const int g = H / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)g * D + 2 * (size_t)kTile * (D + 4) + (size_t)g * kTile + 3 * (size_t)g);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_split_kernel<T><<<dim3(n_splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), H, Hkv, D, S, n_splits, split_len, scale,
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<T><<<dim3(H, B), 128, 0, stream>>>(
      static_cast<const int*>(lengths), H, D, S, n_splits, split_len,
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, D), k and v (B, S, Hkv, D), all contiguous, of one type (is_bf16: bf16, else
// float32); lengths (B,) int32; partials: m and l (B, H, n_splits), acc (B, H, n_splits, D)
// float32; out (B, H, D) of q's type.  D % 8 == 0, D <= 256, (H / Hkv) * D <= 4096;
// split_len a multiple of 64 with n_splits * split_len >= S.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, int B, int H, int Hkv, int D,
                                      long long S, int n_splits, long long split_len,
                                      float scale, void* part_m, void* part_l, void* part_acc,
                                      void* out, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, lengths, B, H, Hkv, D, S, n_splits, split_len, scale,
                                 part_m, part_l, part_acc, out, st);
  return launch<float>(q, k, v, lengths, B, H, Hkv, D, S, n_splits, split_len, scale, part_m,
                       part_l, part_acc, out, st);
}
