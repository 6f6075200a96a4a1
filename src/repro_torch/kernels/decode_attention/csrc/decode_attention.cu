// GQA flash-decode: one query token per sequence attends over a padded KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py:29
// (decode_kernel, launched by _grid_decode at :98).  That kernel walks the
// whole cache in order on one core, carrying the online-softmax state
// (m, l, acc) across S blocks in scratch memory, and masks positions at or
// past each sequence's length.  Hopper runs blocks in parallel and in no
// order, and a grid of (batch, KV head) alone is 16 blocks at glm4-9b's B=8,
// Hkv=2 on 132 SMs, so the cache is split along S as well (flash-decoding):
//
//   pass 1, grid (split, KV head [x row tile], batch): a block streams its
//     split of the cache in tiles of 64 positions through shared memory,
//     once for the whole q-group of its KV head (16 queries at glm4-9b, 5
//     at qwen3-14b, 1 at gemma-7b), and writes its (m, l, acc) partials.
//     Splits and tiles at or past the sequence's length are never loaded;
//     only the last tile masks, with the finite -1e30 of the Pallas kernel,
//     so no score is ever -inf and nothing is NaN.
//   pass 2, grid (head, batch): combines the valid splits in a fixed order
//     and divides by max(l, 1e-30), as the Pallas finalize does.
// No atomics: two runs agree bit for bit.
//
// Bound on an H100 (3.35 TB/s): bytes, K and V of the valid positions read
// once: at glm4-9b, B=8, S=32 768, bf16, 268 MB, 80 us.  At glm4-9b's group
// of 16 every bf16 byte of K and V takes 16 operations, 53.6 TFLOP/s at the
// memory's rate: 80% of the float32 CUDA-core peak before any shared-memory
// traffic, so CUDA cores cannot reach the bytes bound, and tensor cores can.
// Two designs of pass 1, chosen by kernel.py::design by dtype and D alone:
//
// decode_mma_kernel (bf16, D % 16 == 0, D <= 256), "mma.sync+cp.async":
//   * K and V tiles stay bf16 in shared memory (rows padded by 16 bytes, so
//     the fragment loads below hit 32 distinct banks), in a ring of 3 tiles
//     filled by 16-byte cp.async.cg copies: a split's first 3 tiles are
//     requested at once (serving's short splits are 3 tiles: one wait), and
//     each stage is refilled as soon as its tile is computed, so the next
//     tiles' loads are in flight while one is computed; positions past the
//     split's end are zero-filled (never read from memory);
//   * the q-group is the 16 rows of mma.sync.m16n8k16 (bf16 -> f32): a
//     group of 5 or 1 pads with zero rows that are never stored, a group
//     over 16 takes more row tiles (a grid dimension).  Q lives in
//     registers as A fragments for the whole split;
//   * each of the 4 warps owns 16 positions of every tile and keeps its own
//     online softmax on the accumulator fragments (a row spans a quad);
//     S = Q K^T takes K's rows as B fragments directly, P (rounded to bf16 in
//     place) is the A fragment of O += P V, whose B fragments come from V's
//     rows by ldmatrix.trans; at the split's end the 4 warps' states are
//     merged in a fixed order through shared memory.
//
// decode_split_kernel (float32, and bf16 at any other D), "cuda-core": the
//   port's first design, unchanged: math in float32 on CUDA cores, K and V
//   widened to float32 in shared memory.  The tensor cores have no
//   full-float32 product, and TF32's 10 mantissa bits would break the 2e-5
//   float32 limit the kernel is held to; the served models decode in bf16.
//
// An int8 cache (mistral-nemo's kv_cache_dtype="int8": int8 K/V codes and a
// float32 scale a (position, KV head)) runs in either design, chosen as
// above by q's type.  repro dequantizes the whole cache in jnp before its
// attention (src/repro/models/attention.py:241-266: float32(code) * scale,
// rounded to q's type); here each tile is dequantized the same way, element
// by element (__fmul_rn, never fused into an FMA, then rounded to q's type),
// on its way into the tile that the products read, and no dequantized copy
// of the cache ever reaches HBM.  The reason for the int8 cache is its
// bytes: at mistral-nemo's served shape (B=8, Hkv=8, D=128, S=2080) the
// codes are 34.1 MB and the scales 1.1 MB, a bound of 10.5 us, against
// 68.2 MB and 20.3 us for the same cache in bf16.
//
// decode_mma_q8_kernel (bf16 q over an int8 cache), the mma design for its
// own traffic.  Dequantizing adds ~2.5 instructions a code to the bf16
// kernel's work, and a block of 4 warps that waits on block barriers cannot
// hide their latency; so:
//   * each warp streams its own 16 positions of every 64-position tile
//     through a ring of its own (kQ8Stages slices of codes and scales by
//     cp.async, 4736 bytes a slice at D = 128), with a warp barrier a slice:
//     no warp waits for another until the final merge;
//   * a lane dequantizes in registers, into its own B fragments, with no
//     bf16 tile in shared memory: for Q K^T 4 adjacent codes of a key's row
//     a 16-column step (one 32-bit read and the key's scale; the A fragments
//     of Q take the same 4 columns, a permutation of D inside each step that
//     the sum over D does not see), for P V one 32-bit read of each of its 4
//     keys a group of 32 output columns and their 4 scales (the group's
//     columns dealt 4 to a fragment column, undone when the warps merge);
//     row strides of D + 16 bytes put both reads on 32 distinct banks; no
//     branch in a slice (steps past D read zero codes), so its reads issue
//     ahead of its products and the two key blocks' chains interleave;
//     codes become floats by an exponent trick, not I2F (code_of);
//   * the freed shared memory (the PR 28 design's bf16 warp tiles, 34 816
//     bytes at D = 128) and launch bounds of kQ8Blocks blocks an SM let 3
//     blocks share an SM at D = 128, and kernel.py's int8 plan splits the
//     cache for them (mma_grid_plan).
// tools/time_int8_decode_designs.py keeps the PR 28 design as text and times
// both in one call.

#include <cstdint>

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

// Elements of one staged pack: 16 bytes of float or bf16, 8 int8 codes.
template <typename T> struct Pack { static constexpr int kElems = 16 / sizeof(T); };
template <> struct Pack<int8_t> { static constexpr int kElems = 8; };

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// One dequantized element as repro computes it: float32(code) * scale in
// float32 (never contracted into an FMA), rounded to the query's type T.
template <typename T> __device__ __forceinline__ float dequant(int8_t code, float scale);
template <> __device__ __forceinline__ float dequant<float>(int8_t code, float scale) {
  return __fmul_rn((float)code, scale);
}
template <> __device__ __forceinline__ float dequant<__nv_bfloat16>(int8_t code, float scale) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn((float)code, scale)));
}

// Widen 8 int8 codes at src (8-byte aligned), dequantized for queries of type T.
template <typename T>
__device__ __forceinline__ void load_pack_q8(const int8_t* __restrict__ src, float scale,
                                             float* dst) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = dequant<T>(c[e], scale);
}

// T: the query's (and output's) type; C: the cache's, T or int8_t (then
// k_scale and v_scale, (B, S, Hkv) float32, dequantize it).
template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const C* __restrict__ k, const C* __restrict__ v,
                    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                    const int* __restrict__ lengths, int H, int Hkv, int D, long long S,
                    int n_splits, long long split_len, float scale, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc) {
  constexpr int E = Pack<C>::kElems;  // of a staged K/V pack
  constexpr int EQ = Pack<T>::kElems;
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
  for (int i = tid; i < g * D / EQ; i += kThreads) load_pack(qg + i * EQ, q_s + i * EQ);
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
        const long long row = ((long long)b * S + t0 + r) * Hkv + kvh;
        if constexpr (sizeof(C) == 1) {
          load_pack_q8<T>(k + row * D + c, k_scale[row], kd);
          load_pack_q8<T>(v + row * D + c, v_scale[row], vd);
        } else {
          load_pack(k + row * D + c, kd);
          load_pack(v + row * D + c, vd);
        }
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

template <typename T, typename C>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           const void* lengths, int B, int H, int Hkv, int D, long long S, int n_splits,
           long long split_len, float scale, void* part_m, void* part_l, void* part_acc,
           void* out, cudaStream_t stream) {
  const int g = H / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)g * D + 2 * (size_t)kTile * (D + 4) + (size_t)g * kTile + 3 * (size_t)g);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_split_kernel<T, C><<<dim3(n_splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k), static_cast<const C*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
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


// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync.m16n8k16 over a cp.async ring.

constexpr int kMmaThreads = 128;  // 4 warps, each 16 positions of a tile
constexpr int kMmaStages = 3;     // tiles of the ring
constexpr int kRowPad = 8;        // bf16 padding of a staged row (16 bytes)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kRowPad8 = 16;  // byte padding of a staged row of int8 codes
constexpr int kQ8Stages = 3;  // 16-position slices a warp keeps in flight
// Blocks an SM the int8 kernel's registers are bounded for (launch bounds) at
// D <= 128 (168 registers a thread); at larger D the accumulators need more,
// and 2 blocks fit.
constexpr int kQ8Blocks = 3;

// Shared memory of one block at head dimension D: the ring of K and V tiles,
// which the warps' merge reuses (4 x 16 x D floats and 2 x 64 floats fit in
// it).  An int8 cache's block: each warp's own ring of kQ8Stages slices, a
// slice 16 rows of K codes and 16 of V codes (rows of D + 16 bytes) and their
// 32 scales; the merge's 64 D + 128 floats fit in it too.  kernel.py's
// decode_plan computes the same figures and passes them in.
constexpr int mma_smem_bytes(int D) { return kMmaStages * 2 * kTile * (D + kRowPad) * 2; }
__host__ __device__ constexpr int q8_slice_bytes(int D) {
  return 2 * 16 * (D + kRowPad8) + 2 * 16 * 4;
}
__host__ __device__ constexpr int mma_q8_smem_bytes(int D) {
  return 4 * kQ8Stages * q8_slice_bytes(D);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or 16 zero bytes when bytes == 0 (src not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
// 4 bytes from src to dst, or 4 zero bytes when bytes == 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The online softmax of a warp's 16 keys key0 .. key0 + 15 (scores of 16 rows
// x 16 keys: register 2r + e of n-block nb is row qr + 8r, key key0 + 8 nb +
// qc + e), in the log2 domain: masks keys at or past s_end, updates the
// running max m and sum l, rescales O, and returns P (rounded to bf16) as the
// A fragment of O += P V.
template <int NT>
__device__ __forceinline__ void softmax_16(float (&sc)[2][4], float (&m)[2], float (&l)[2],
                                           float (&o)[2 * NT][4], long long key0,
                                           long long s_end, int qc, float scale_log2,
                                           uint32_t (&pa)[4]) {
  const bool last = key0 + 16 > s_end;  // only the split's last keys mask
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = sc[nb][2 * r + e] * scale_log2;
        if (last && key0 + 8 * nb + qc + e >= s_end) x = kNegInf;
        sc[nb][2 * r + e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
  float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float p0 = exp2f(sc[nb][2 * r] - m[r]), p1 = exp2f(sc[nb][2 * r + 1] - m[r]);
      sum[r] += p0 + p1;
      pa[2 * nb + r] = pack_bf16(p0, p1);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
}

// The 4 warps' states, staged by the caller in w_acc [4][16][D], w_m and w_l
// [4][16] (the ring's memory, after a barrier), merged in a fixed order into
// the block's partials (m in the natural-log domain, as decode_split_kernel
// writes them, so decode_combine_kernel finishes both designs).
__device__ __forceinline__ void merge_warps(const float* w_acc, const float* w_m, const float* w_l,
                                            int rows, int D, long long head0, int n_splits,
                                            int split, float* __restrict__ part_m,
                                            float* __restrict__ part_l,
                                            float* __restrict__ part_acc) {
  for (int i = threadIdx.x; i < rows * D; i += kMmaThreads) {
    const int gi = i / D, d = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mm = fmaxf(mm, w_m[w * 16 + gi]);
    float ll = 0.0f, acc = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float s = exp2f(w_m[w * 16 + gi] - mm);  // 0 for a warp that saw no key
      ll = fmaf(s, w_l[w * 16 + gi], ll);
      acc = fmaf(s, w_acc[(w * 16 + gi) * D + d], acc);
    }
    part_acc[((head0 + gi) * n_splits + split) * D + d] = acc;
    if (d == 0) {
      part_m[(head0 + gi) * n_splits + split] = mm * kLn2;
      part_l[(head0 + gi) * n_splits + split] = ll;
    }
  }
}

// NT: 16-column steps of D the registers are sized for (D <= 16 NT); the
// steps at or past D / 16 are skipped.  Writes partials as decode_split_kernel
// does (m in the natural-log domain), so decode_combine_kernel finishes both.
template <int NT>
__global__ void __launch_bounds__(kMmaThreads)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths, int H,
                  int Hkv, int D, long long S, int n_splits, long long split_len,
                  float scale_log2, float* __restrict__ part_m, float* __restrict__ part_l,
                  float* __restrict__ part_acc) {
  const int g = H / Hkv, row_tiles = (g + 15) / 16;
  const int split = blockIdx.x, kvh = blockIdx.y / row_tiles, g0 = 16 * (blockIdx.y % row_tiles);
  const int b = blockIdx.z;
  const long long len = min((long long)lengths[b], S);
  const long long s_begin = (long long)split * split_len;
  if (s_begin >= len) return;  // past this sequence's length: pass 2 reads no partial here
  const long long s_end = min(s_begin + split_len, len);
  const int n_tiles = (int)((s_end - s_begin + kTile - 1) / kTile);
  const int rows = min(16, g - g0);  // query rows of this block's row tile
  const int nt = D / 16;
  const int ld = D + kRowPad;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qr = lane >> 2, qc = 2 * (lane & 3);  // fragment row (and row + 8) and column pair
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // stage s: K [64][ld], V [64][ld]

  auto load_tile = [&](int t) {
    const long long t0 = s_begin + (long long)kTile * t;
    const int valid = (int)min((long long)kTile, s_end - t0);
    __nv_bfloat16* ks = ring + (t % kMmaStages) * 2 * kTile * ld;
    __nv_bfloat16* vs = ks + kTile * ld;
    const int chunks = D / 8;  // 16-byte chunks of a row
    for (int i = tid; i < kTile * chunks; i += kMmaThreads) {
      const int r = i / chunks, c = (i % chunks) * 8;
      const long long off = (((long long)b * S + t0 + min(r, valid - 1)) * Hkv + kvh) * D + c;
      const int bytes = r < valid ? 16 : 0;
      cp_async16(ks + r * ld + c, k + off, bytes);
      cp_async16(vs + r * ld + c, v + off, bytes);
    }
  };
#pragma unroll
  for (int t = 0; t < kMmaStages; ++t) {  // the whole ring in flight: a short split waits once
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  // the block's queries as A fragments: rows g0 + qr and g0 + qr + 8 of the group
  const __nv_bfloat16* qg = q + ((long long)b * H + (long long)kvh * g + g0) * D;
  uint32_t qa[NT][4];
#pragma unroll
  for (int kk = 0; kk < NT; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = qr + 8 * (i & 1), c = 16 * kk + qc + 8 * (i >> 1);
      qa[kk][i] = (kk < nt && r < rows) ? *reinterpret_cast<const uint32_t*>(qg + r * D + c) : 0u;
    }

  float o[2 * NT][4];
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kMmaStages - 1>();  // tile t has landed (this thread's copies)
    __syncthreads();                  // and everyone's
    const long long key0 = s_begin + (long long)kTile * t + 16 * warp;  // the warp's 16 keys
    if (key0 < s_end) {  // else none of them is valid: nothing to add
      const __nv_bfloat16* ks = ring + (t % kMmaStages) * 2 * kTile * ld + 16 * warp * ld;
      const __nv_bfloat16* vs = ks + kTile * ld;

      float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        if (kk >= nt) break;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const __nv_bfloat16* kr = ks + (8 * nb + qr) * ld + 16 * kk + qc;
          mma_16816(sc[nb], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                    *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
      uint32_t pa[4];
      softmax_16<NT>(sc, m, l, o, key0, s_end, qc, scale_log2, pa);
      // B fragments of V (16 keys x 16 columns) by ldmatrix.trans: lanes 0-7
      // address keys 0-7, lanes 8-15 keys 8-15, lanes 16-31 the same 8 columns on
      const __nv_bfloat16* vl = vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4);
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        if (kk >= nt) break;
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vl + 16 * kk);
        mma_16816(o[2 * kk], pa, vb[0], vb[1]);
        mma_16816(o[2 * kk + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // everyone is done with tile t's stage: refill it
    if (t + kMmaStages < n_tiles) load_tile(t + kMmaStages);
    cp_async_commit();
  }

  // merge the 4 warps' states in a fixed order through the ring's memory
  cp_async_wait<0>();
  __syncthreads();
  float* w_acc = reinterpret_cast<float*>(smem_raw);  // [4][16][D]
  float* w_m = w_acc + 4 * 16 * D;                     // [4][16]
  float* w_l = w_m + 4 * 16;                           // [4][16]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qr + 8 * r;
    const float lr = quad_sum(l[r]);
    float* dst = w_acc + (warp * 16 + row) * D + qc;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      if (j >= 2 * nt) break;
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[j][2 * r], o[j][2 * r + 1]);
    }
    if ((lane & 3) == 0) {
      w_m[warp * 16 + row] = m[r];
      w_l[warp * 16 + row] = lr;
    }
  }
  __syncthreads();
  merge_warps(w_acc, w_m, w_l, rows, D, (long long)b * H + (long long)kvh * g + g0, n_splits,
              split, part_m, part_l, part_acc);
}

// Code i (0..3) of the word w as a float, exactly, without a conversion
// instruction (I2F issues at a quarter of the FP32 rate): the float
// 0x4B0000xx is 2^23 + xx, and xx = code + 128 is the byte with its top bit
// flipped, so subtracting 2^23 + 128 leaves the code.
__device__ __forceinline__ float code_of(uint32_t w, int i) {
  const uint32_t x = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7650u | (uint32_t)i);
  return __fsub_rn(__uint_as_float(x), 8388736.0f);
}

// Two dequantized elements, float32(code) * scale (never fused into an FMA)
// rounded to bf16 as repro rounds them to q's type, packed as a fragment
// register with the first in the low half.
__device__ __forceinline__ uint32_t dequant2(float c0, float s0, float c1, float s1) {
  return pack_bf16(__fmul_rn(c0, s0), __fmul_rn(c1, s1));
}

// Column of D that C-fragment column n (0..7) of output n-block j holds in the
// int8 kernel: the n-blocks of a group of 32 columns deal 4 adjacent columns
// to each B-fragment column (a last group of 16, where D % 32 == 16, 2), so a
// lane reads V's codes a 32-bit word (16-bit) a key and group.
__device__ __forceinline__ int q8_column(int j, int n, int D) {
  const int G = j >> 2, width = min(32, D - 32 * G);
  return 32 * G + n * (width / 8) + (j & 3);
}

// The int8 cache's mma design: as decode_mma_kernel, but each warp streams
// its own 16 positions of every 64-position tile (a slice) through a ring of
// its own (kQ8Stages slices of codes and scales by cp.async, a warp barrier
// a slice: no warp waits for another until the merge), and dequantizes in
// registers, into the fragments: for Q K^T a lane reads 4 adjacent codes of
// a key's row a 16-column step (one word; the A fragments take Q's same
// columns, a permutation of D inside each step that the sum over D does not
// see) and one scale; for P V one word of each of its 4 keys a group of 32
// columns (q8_column) and their 4 scales.
template <int NT>
__global__ void __launch_bounds__(kMmaThreads, NT <= 8 ? kQ8Blocks : 1)
decode_mma_q8_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                     const int8_t* __restrict__ v, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, const int* __restrict__ lengths, int H,
                     int Hkv, int D, long long S, int n_splits, long long split_len,
                     float scale_log2, float* __restrict__ part_m, float* __restrict__ part_l,
                     float* __restrict__ part_acc) {
  const int g = H / Hkv, row_tiles = (g + 15) / 16;
  const int split = blockIdx.x, kvh = blockIdx.y / row_tiles, g0 = 16 * (blockIdx.y % row_tiles);
  const int b = blockIdx.z;
  const long long len = min((long long)lengths[b], S);
  const long long s_begin = (long long)split * split_len;
  if (s_begin >= len) return;  // past this sequence's length: pass 2 reads no partial here
  const long long s_end = min(s_begin + split_len, len);
  const int rows = min(16, g - g0);  // query rows of this block's row tile
  const int nt = D / 16;
  const int ld8 = D + kRowPad8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qr = lane >> 2, qc = 2 * (lane & 3), c4 = 4 * (lane & 3);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // this warp's ring: slice t at + (t % kQ8Stages) * q8_slice_bytes(D): K codes
  // [16][ld8], V codes [16][ld8], K scales [16], V scales [16]
  uint8_t* ring = smem_raw + warp * kQ8Stages * q8_slice_bytes(D);
  // the warp's slices: positions first + 64 t .. + 15, those that start before s_end
  const long long first = s_begin + 16 * warp;
  const int n_slices = first < s_end ? (int)((s_end - first + kTile - 1) / kTile) : 0;

  auto slice = [&](int t) { return ring + (t % kQ8Stages) * q8_slice_bytes(D); };
  auto load_slice = [&](int t) {
    const long long key0 = first + (long long)kTile * t;
    const int valid = (int)min(16LL, s_end - key0);
    int8_t* ks = reinterpret_cast<int8_t*>(slice(t));
    int8_t* vs = ks + 16 * ld8;
    float* ss = reinterpret_cast<float*>(vs + 16 * ld8);
    const int chunks = D / 16;  // 16-byte chunks of a row of codes
    for (int i = lane; i < 16 * chunks; i += 32) {
      const int r = i / chunks, c = (i % chunks) * 16;
      const long long off = (((long long)b * S + key0 + min(r, valid - 1)) * Hkv + kvh) * D + c;
      const int bytes = r < valid ? 16 : 0;
      cp_async16(ks + r * ld8 + c, k + off, bytes);
      cp_async16(vs + r * ld8 + c, v + off, bytes);
    }
    if (lane < 16) {  // zero codes and scales past the split's end
      const long long row = ((long long)b * S + key0 + min(lane, valid - 1)) * Hkv + kvh;
      const int bytes = lane < valid ? 4 : 0;
      cp_async4(ss + lane, k_scale + row, bytes);
      cp_async4(ss + 16 + lane, v_scale + row, bytes);
    }
  };
#pragma unroll
  for (int t = 0; t < kQ8Stages; ++t) {  // the whole ring in flight
    if (t < n_slices) load_slice(t);
    cp_async_commit();
  }

  // the block's queries as A fragments, rows g0 + qr and g0 + qr + 8 of the
  // group: in step kk, Q's columns 16 kk + c4 .. + 3 (a0 | a2, a1 | a3)
  const __nv_bfloat16* qg = q + ((long long)b * H + (long long)kvh * g + g0) * D;
  uint32_t qa[NT][4];
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint2 lo = make_uint2(0u, 0u), hi = make_uint2(0u, 0u);
    if (kk < nt && qr < rows) lo = *reinterpret_cast<const uint2*>(qg + qr * D + 16 * kk + c4);
    if (kk < nt && qr + 8 < rows)
      hi = *reinterpret_cast<const uint2*>(qg + (qr + 8) * D + 16 * kk + c4);
    qa[kk][0] = lo.x;
    qa[kk][1] = hi.x;
    qa[kk][2] = lo.y;
    qa[kk][3] = hi.y;
  }

  float o[2 * NT][4];
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_slices; ++t) {
    cp_async_wait<kQ8Stages - 1>();  // slice t has landed (this lane's copies)
    __syncwarp();                    // and the warp's
    const int8_t* ks = reinterpret_cast<const int8_t*>(slice(t));
    const int8_t* vs = ks + 16 * ld8;
    const float* ss = reinterpret_cast<const float*>(vs + 16 * ld8);
    const long long key0 = first + (long long)kTile * t;

    // S = Q K^T: B column qr of n-block nb is key key0 + 8 nb + qr; its
    // elements of step kk are the codes 16 kk + c4 .. + 3 of that key's row.
    // No branch: the steps past D / 16 (D below the registers' 16 NT) read
    // zero codes against Q's zero columns, so every read of the slice is
    // issued ahead of its products and the two n-blocks' chains interleave
    float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    const int8_t* kr = ks + qr * ld8 + c4;
    const float sk[2] = {ss[qr], ss[8 + qr]};
#pragma unroll
    for (int kk = 0; kk < NT; ++kk)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const uint32_t w =
            kk < nt ? *reinterpret_cast<const uint32_t*>(kr + 8 * nb * ld8 + 16 * kk) : 0u;
        mma_16816(sc[nb], qa[kk], dequant2(code_of(w, 0), sk[nb], code_of(w, 1), sk[nb]),
                  dequant2(code_of(w, 2), sk[nb], code_of(w, 3), sk[nb]));
      }
    uint32_t pa[4];
    softmax_16<NT>(sc, m, l, o, key0, s_end, qc, scale_log2, pa);

    // O += P V: B fragment of n-block j is V at keys qc, qc + 1 (b0) and
    // qc + 8, qc + 9 (b1) of the slice, at column q8_column(j, qr).  A group
    // of 32 columns reads a word a key, a last one of 16 (D % 32 == 16) a
    // half word; past D zero codes, into n-blocks that are never written
    const int8_t* vr = vs + qc * ld8;
    const int rows_at[4] = {0, ld8, 8 * ld8, 9 * ld8};  // keys qc, qc + 1, qc + 8, qc + 9
    const float sv[4] = {ss[16 + qc], ss[17 + qc], ss[24 + qc], ss[25 + qc]};
#pragma unroll
    for (int G = 0; G < (NT + 1) / 2; ++G) {
      const int width = D - 32 * G;  // columns left: >= 32, 16, or none
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = vr + rows_at[i] + 32 * G;
        w[i] = width >= 32 ? *reinterpret_cast<const uint32_t*>(p + 4 * qr)
               : width == 16 ? (uint32_t)*reinterpret_cast<const uint16_t*>(p + 2 * qr) : 0u;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * G + e < 2 * NT)
          mma_16816(o[4 * G + e], pa, dequant2(code_of(w[0], e), sv[0], code_of(w[1], e), sv[1]),
                    dequant2(code_of(w[2], e), sv[2], code_of(w[3], e), sv[3]));
    }
    __syncwarp();  // every lane is done with slice t's stage: refill it
    if (t + kQ8Stages < n_slices) load_slice(t + kQ8Stages);
    cp_async_commit();
  }

  // merge the 4 warps' states in a fixed order through the rings' memory
  cp_async_wait<0>();
  __syncthreads();
  float* w_acc = reinterpret_cast<float*>(smem_raw);  // [4][16][D]
  float* w_m = w_acc + 4 * 16 * D;                     // [4][16]
  float* w_l = w_m + 4 * 16;                           // [4][16]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qr + 8 * r;
    const float lr = quad_sum(l[r]);
    float* dst = w_acc + (warp * 16 + row) * D;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      if (j >= 2 * nt) break;
      dst[q8_column(j, qc, D)] = o[j][2 * r];
      dst[q8_column(j, qc + 1, D)] = o[j][2 * r + 1];
    }
    if ((lane & 3) == 0) {
      w_m[warp * 16 + row] = m[r];
      w_l[warp * 16 + row] = lr;
    }
  }
  __syncthreads();
  merge_warps(w_acc, w_m, w_l, rows, D, (long long)b * H + (long long)kvh * g + g0, n_splits,
              split, part_m, part_l, part_acc);
}

// C: the cache's type, bf16 (decode_mma_kernel) or int8_t (decode_mma_q8_kernel,
// with k_scale and v_scale).
template <int NT, typename C>
int launch_mma(const void* q, const void* k, const void* v, const void* k_scale,
               const void* v_scale, const void* lengths, int B, int H, int Hkv, int D,
               long long S, int n_splits, long long split_len, float scale, int smem,
               void* part_m, void* part_l, void* part_acc, void* out, cudaStream_t stream) {
  constexpr bool kQ8 = sizeof(C) == 1;
  const int need = kQ8 ? mma_q8_smem_bytes(D) : mma_smem_bytes(D);
  if (smem < need || smem < 4 * 16 * D * 4 + 2 * 64 * 4) return (int)cudaErrorInvalidValue;
  const int row_tiles = (H / Hkv + 15) / 16;
  const dim3 grid(n_splits, Hkv * row_tiles, B);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* len = static_cast<const int*>(lengths);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  if constexpr (kQ8) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          decode_mma_q8_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    decode_mma_q8_kernel<NT><<<grid, kMmaThreads, smem, stream>>>(
        qb, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
        static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), len, H, Hkv, D, S,
        n_splits, split_len, scale * kLog2e, pm, pl, pa);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          decode_mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    decode_mma_kernel<NT><<<grid, kMmaThreads, smem, stream>>>(
        qb, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), len, H,
        Hkv, D, S, n_splits, split_len, scale * kLog2e, pm, pl, pa);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<__nv_bfloat16><<<dim3(H, B), 128, 0, stream>>>(
      len, H, D, S, n_splits, split_len, pm, pl, pa, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, D), k and v (B, S, Hkv, D), all contiguous, q of one type (is_bf16: bf16, else
// float32) and k and v of q's type, or int8 codes with k_scale and v_scale (B, S, Hkv)
// float32 (null for a cache of q's type); lengths (B,) int32; partials: m and l
// (B, H, n_splits), acc (B, H, n_splits, D) float32; out (B, H, D) of q's type.
// D % 8 == 0, D <= 256, (H / Hkv) * D <= 4096; split_len a multiple of 64 with
// n_splits * split_len >= S.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* lengths, int B, int H, int Hkv, int D,
                                      long long S, int n_splits, long long split_len,
                                      float scale, void* part_m, void* part_l, void* part_acc,
                                      void* out, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  if ((k_scale == nullptr) != (v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SPLIT(T, C)                                                                  \
  return launch<T, C>(q, k, v, k_scale, v_scale, lengths, B, H, Hkv, D, S, n_splits,       \
                      split_len, scale, part_m, part_l, part_acc, out, st)
  if (k_scale != nullptr) {
    if (is_bf16) REPRO_SPLIT(__nv_bfloat16, int8_t);
    REPRO_SPLIT(float, int8_t);
  }
  if (is_bf16) REPRO_SPLIT(__nv_bfloat16, __nv_bfloat16);
  REPRO_SPLIT(float, float);
#undef REPRO_SPLIT
}

// bf16 q (B, H, D), k and v (B, S, Hkv, D) bf16, or int8 codes with k_scale and
// v_scale (B, S, Hkv) float32 (null for a bf16 cache), contiguous and 16-byte
// aligned; lengths (B,) int32; partials: m and l (B, H, n_splits), acc
// (B, H, n_splits, D) float32; out (B, H, D) bf16.  D % 16 == 0, D <= 256;
// split_len a multiple of 64 with n_splits * split_len >= S; smem_bytes from
// kernel.py's decode_plan.
extern "C" int repro_decode_attention_mma(const void* q, const void* k, const void* v,
                                          const void* k_scale, const void* v_scale,
                                          const void* lengths, int B, int H, int Hkv, int D,
                                          long long S, int n_splits, long long split_len,
                                          float scale, int smem_bytes, void* part_m,
                                          void* part_l, void* part_acc, void* out,
                                          void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  if (D <= 0 || D % 16 || D > 256) return (int)cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_MMA(NT, C)                                                                    \
  return launch_mma<NT, C>(q, k, v, k_scale, v_scale, lengths, B, H, Hkv, D, S, n_splits,     \
                           split_len, scale, smem_bytes, part_m, part_l, part_acc, out, st)
#define REPRO_MMA_D(C)          \
  if (D <= 16) REPRO_MMA(1, C);  \
  if (D <= 32) REPRO_MMA(2, C);  \
  if (D <= 64) REPRO_MMA(4, C);  \
  if (D <= 128) REPRO_MMA(8, C); \
  REPRO_MMA(16, C)
  if (k_scale != nullptr) {
    REPRO_MMA_D(int8_t);
  }
  REPRO_MMA_D(__nv_bfloat16);
#undef REPRO_MMA_D
#undef REPRO_MMA
}
