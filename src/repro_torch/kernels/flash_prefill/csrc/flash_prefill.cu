// GQA flash attention over a whole prompt, causal or not: two designs in one library.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_prefill/kernel.py:29
// (prefill_kernel, launched by _grid_prefill at :102).  That kernel runs a
// grid (B, H, q block, kv block) in order, carrying the online-softmax state
// across kv blocks in scratch memory; it skips kv blocks above the diagonal
// and masks only the one that straddles it.  Hopper runs blocks in parallel
// and in no order, so here a block owns one (query tile, query head, batch)
// and loops over the key tiles up to the diagonal itself, keeping the state
// in registers.  Query head h reads KV head h / (H / Hkv), as the Pallas
// index map does; query tiles are scheduled longest first.
//
// A non-causal mode (causal = 0) computes what repro's jnp flash_attention
// does with causal=False (src/repro/models/attention.py:67), which no Pallas
// kernel has: S query rows over T keys, T == S for an encoder's
// self-attention (whisper's, S = T = 1500) and T != S for cross-attention
// over an encoder's T rows.  A block then walks every key tile up to T; the
// key tiles come from K's own length (the loop bound, and in the wgmma
// design K's and V's tensor maps), and only a last tile that runs past T
// masks, with the same finite -1e30.  The causal mode needs T == S
// (kernel.py checks it).  Bound of the non-causal mode: 4 B H S T D
// operations over the bf16 tensor-core peak: at whisper's encoder, B=8,
// H=20, S=T=1500, D=64, 9.22e10 operations, 93.2 us.
//
// Bound on an H100: operations, 4 B H (S^2 / 2) D over the 989 TFLOP/s bf16
// tensor-core peak: at glm4-9b, B=1, S=4096, 1.37e11 operations, 139 us.
// No CUDA-core design can come near it (67 TFLOP/s float32 is 2.05 ms), so
// bf16 runs on the tensor cores:
//
// repro_flash_prefill_wgmma (bf16, D in {64, 96, 128, 192, 256}):
//   * a block of two consumer warpgroups owns a 128-row query tile, 64 rows
//     each; key tiles are 128 keys at D <= 128 and 64 at larger D, where the
//     output accumulator alone is 3 or 4 x 32 floats a thread;
//   * one thread of a third, producer warpgroup issues TMA loads: the Q tile
//     once, and K and V tiles into a two-stage ring with full and empty
//     mbarriers, so tile j + 1 is in flight while tile j is computed and
//     neither consumer waits for the other to refill a stage.  The tensor
//     maps are 4-D over (D, heads, S, B) with boxes of (64, 1, rows, 1) and
//     the 128-byte swizzle, built on the host for each call from the
//     (B, S, H, D) strides (no copy, no transpose); rows at or past S are
//     filled with zeros by the TMA unit;
//   * D = 96 (phi-3-vision's heads, 192 bytes a row) is no multiple of the
//     128-byte swizzle's 64 columns, so there a row is three boxes of 32
//     columns (64 bytes) under the 64-byte swizzle, and every descriptor
//     takes that mode (an atom of 8 rows x 64 bytes, 512 bytes apart).  Of
//     the two layouts that fit 192 bytes (three 64-byte boxes, or a 128-byte
//     box beside a 64-byte one) the uniform one keeps one descriptor rule,
//     one loop of 2 k-steps a box for Q K^T (6 in all), and a single P V
//     product a k-step, m64n96k16, whose MN-major B walks the three boxes by
//     the descriptor's leading byte offset (a box apart), so the O
//     accumulator is one fragment of 48 floats a thread; on the card that
//     product ran faster than three m64n32 products, one a box, and the
//     mixed layout would need two descriptor modes and two P V products a
//     k-step.  Key tiles are 128 keys; shared memory 124 032 bytes, one
//     block an SM;
//   * S = Q K^T by wgmma m64nNk16 with A and B from shared memory (both
//     K-major); the online softmax runs in registers on the accumulator's own
//     layout (a row spans the 4 threads of a quad: two shuffles a max);
//   * O += P V by wgmma m64n64k16 (m64n96k16 at D = 96) with P from
//     registers (the f32 accumulator rounded to bf16 in place: its layout
//     is the A fragment's) and V from
//     shared memory as an MN-major B (D-contiguous rows, the transpose flag),
//     so nothing is transposed in shared memory;
//   * the warpgroups take turns on the tensor cores: in its turn one issues
//     S_j and P_{j-1} V_{j-1}, then runs the softmax of S_j while the other's
//     products run, so the SM's exp2 and tensor-core work overlap; the
//     softmax is one FFMA and one ex2 a score (log2(e) / sqrt(D) folded into
//     the scale), and the producer warpgroup gives its registers to the two
//     consumers (setmaxnreg), whose S, P and O fragments take ~200 a thread;
//   * tiles above the block's diagonal are never loaded; only the tiles
//     that straddle a warpgroup's diagonal mask, with the finite -1e30; the
//     epilogue divides by max(l, 1e-30), rounds to bf16 and never writes a
//     row at or past S;
//   * no branch that differs between threads of a warpgroup holds a wgmma
//     in flight, and every turn commits the same groups: ptxas serializes
//     the wgmmas of a kernel otherwise (its C7514/C7518 notes).
//
// repro_flash_prefill (float32, and bf16 at any other D % 8 == 0, D <= 256):
//   the CUDA-core design of the port's first version, unchanged.  wgmma has
//   no full-float32 mode, and TF32 keeps 10 mantissa bits, which would break
//   the 2e-5 float32 limit that the kernel is held to; float32 attention is
//   not on the served path (the served models run bf16).  Math in float32
//   on bf16 or f32 loads: the query tile and one K (then V) tile staged in
//   shared memory as float32 rows of D + 4 floats; 256 threads as 16 x 16.
//
// The wrapper (kernel.py::grid_prefill) chooses between the two by dtype and
// D alone (kernel.py::design); a build or launch error of either raises.
//
// Training: both designs take an optional float32 lse (B, H, S).  Where it is
// given, the epilogue also writes each row's natural log-sum-exp of its
// scaled scores, m / sqrt(D) + ln(l) (the wgmma design keeps m unscaled and
// l in base 2's terms: (m log2(e) / sqrt(D) + log2(l)) ln 2), which
// flash_prefill_bwd.cu reads to recompute P without a second softmax pass.
// The serving call passes a null pointer: the same launch, the same output.
// Training's wgmma forward also splits P into bf16 hi + lo for its P V
// product (kSplitP): with P rounded to bf16 alone, glm4-9b's attention
// weights' gradients came 1.0-4.3% (relative Frobenius) from the plain
// version's, past the 2e-2 that chip_smoke.py's phase 28 holds them to.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../csrc/hopper.cuh"

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
               T* __restrict__ out, float* __restrict__ lse, int S, int T_len, int H, int Hkv,
               int D, float scale, int causal) {
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

  // causal: tiles above the diagonal are never visited; else every tile up to T
  const int n_k = causal ? qi + 1 : (T_len + kTile - 1) / kTile;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done with kv_s and p_s
    stage_tile(k, b, k0, kvh, Hkv, T_len, D, ld, kv_s);
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

    const bool diag = causal && kt == qi;  // the tile that straddles the diagonal: mask it
    const bool ragged = k0 + kTile > T_len;  // keys at or past T: mask them
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        const int key = k0 + tx + 16 * j;
        if ((diag && key > row) || (ragged && key >= T_len)) x = kNegInf;
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
    stage_tile(v, b, k0, kvh, Hkv, T_len, D, ld, kv_s);
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
    if (lse != nullptr && tx == 0) lse[((long long)b * H + h) * S + row] = m[i] + logf(denom);
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
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int T_len, int H, int Hkv, int D, float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)kTile * (D + 4) + (size_t)kTile * (kTile + 1));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_kernel<T, J>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_q = (S + kTile - 1) / kTile;
  prefill_kernel<T, J><<<dim3(n_q, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, T_len, H, Hkv, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
             int T_len, int H, int Hkv, int D, float scale, int causal, cudaStream_t stream) {
#define REPRO_CC(J) launch<T, J>(q, k, v, out, lse, B, S, T_len, H, Hkv, D, scale, causal, stream)
  if (D <= 64) return REPRO_CC(1);
  if (D <= 128) return REPRO_CC(2);
  return REPRO_CC(4);
#undef REPRO_CC
}

}  // namespace

// q (B, S, H, D), k and v (B, T, Hkv, D), out (B, S, H, D), all contiguous and of one type
// (is_bf16: bf16, else float32); lse (B, H, S) float32, or null.  D % 8 == 0 and D <= 256;
// causal needs T == S.
extern "C" int repro_flash_prefill(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int B, int S, int T, int H, int Hkv, int D,
                                   float scale, int causal, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (T <= 0 || (causal && T != S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(q, k, v, out, l, B, S, T, H, Hkv, D, scale, causal, st);
  return launch_d<float>(q, k, v, out, l, B, S, T, H, Hkv, D, scale, causal, st);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: TMA + wgmma.

namespace wg {

using namespace hopper;  // mbarriers, TMA, wgmma and tensor maps (kernels/csrc/hopper.cuh)

constexpr int kRows = 128;                 // query rows of a block: two warpgroups of 64
constexpr int kConsumers = 256;             // the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
// Registers a thread after setmaxnreg: the producer gives its registers to
// the consumers (128 x 24 + 256 x 240 <= 65 536).
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kStages = 2;                  // K/V ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory a block of head dimension D asks for: Q, the K/V ring, its
// mbarriers (Q; full and empty, K and V, a stage), and 1024 bytes to align
// the swizzled tiles.  kernel.py's prefill_plan computes the same figure and
// passes it in.
constexpr int key_tile(int D) { return D <= 128 ? 128 : 64; }
// Columns of a TMA box and of a swizzle atom's row: 64 (128 bytes, the
// 128-byte swizzle) where D is a multiple of 64, else 32 (64 bytes, the
// 64-byte swizzle: D = 96 is three boxes).
__host__ __device__ constexpr int box_cols(int D) { return D % 64 == 0 ? 64 : 32; }
// N of one P V product: a 64-column box at D % 64 == 0, the whole row (96)
// otherwise, its B striding across the boxes.
__host__ __device__ constexpr int pv_cols(int D) { return D % 64 == 0 ? 64 : D; }
constexpr int smem_bytes(int D) {
  return 1024 + kRows * D * 2 + 2 * kStages * key_tile(D) * D * 2 + 128;
}

// Named barriers 1 and 2 hand the tensor cores from one warpgroup to the other.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// D: head dimension (a multiple of 64, or 96); BC: keys of a tile.
//
// Warpgroup 2 is the producer: one thread issues the TMA loads of Q and of
// every K and V tile, each into its stage once both consumer warpgroups have
// released the tile that stage held (every consumer thread arrives on its
// empty barrier: no lane-0 branch while a wgmma is in flight).  The two
// consumers take turns on the tensor cores (named barriers 1 and 2): in its
// turn a warpgroup issues S_j = Q K_j^T and O += P_{j-1} V_{j-1}, then
// passes the turn and runs the softmax of S_j while the other warpgroup's
// products run, so the exp2 work and the tensor-core work of the SM overlap.
//
// kSplitP (training's forward): P enters the P V product as bf16 hi + lo, two
// products a k-step, so that O carries P to 16 bits, not bf16's 8; the
// serving call (kSplitP false) is unchanged.
template <int D, int BC, bool kSplitP>
__global__ void __launch_bounds__(kThreads, 1)
prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int S, int T, int H, int Hkv, float scale_log2,
                     int causal) {
  constexpr int kBoxCols = box_cols(D);    // columns of a box (and of a swizzle atom's row)
  constexpr int kBoxBytes = 2 * kBoxCols;  // 128 or 64 bytes, the swizzle's span
  constexpr int kBoxes = D / kBoxCols;     // boxes of a row
  constexpr int kAtom = 8 * kBoxBytes;     // 8 swizzled rows: the descriptors' stride offset
  constexpr int kSteps = kBoxCols / 16;    // k-steps of Q K^T a box
  constexpr int kPV = pv_cols(D);          // N of a P V product
  constexpr int kPVs = D / kPV;            // P V products a k-step
  constexpr int kQBytes = kRows * D * 2;
  constexpr int kTileBytes = BC * D * 2;   // one K or V tile
  constexpr int kS = BC / 2;               // score registers a thread (m64 x BC)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + kQBytes;                  // stage s at k_s + s * kTileBytes
  const uint32_t v_s = k_s + kStages * kTileBytes;     // stage s at v_s + s * kTileBytes
  const uint32_t bar_q = v_s + kStages * kTileBytes;   // then 4 barriers a stage, 8 bytes each
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages, empty_v = empty_k + 8 * kStages;

  const int n_q = (S + kRows - 1) / kRows;
  const int qi = n_q - 1 - (int)blockIdx.x;  // longest query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int q0 = qi * kRows;
  // causal: key tiles up to the diagonal of the block's last row, and within
  // S; else every key tile up to T
  const int n_kv = causal ? min((q0 + kRows + BC - 1) / BC, (S + BC - 1) / BC) : (T + BC - 1) / BC;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumers);
      mbar_init(empty_v + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, kQBytes);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load(q_s + c * kRows * kBoxBytes, &tm_q, bar_q, kBoxCols * c, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages, round = j / kStages;
        if (round > 0) mbar_wait(empty_k + 8 * s, (round - 1) & 1);
        mbar_expect_tx(full_k + 8 * s, kTileBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load(k_s + s * kTileBytes + c * BC * kBoxBytes, &tm_k, full_k + 8 * s, kBoxCols * c,
                   kvh, j * BC, b);
        if (round > 0) mbar_wait(empty_v + 8 * s, (round - 1) & 1);
        mbar_expect_tx(full_v + 8 * s, kTileBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load(v_s + s * kTileBytes + c * BC * kBoxBytes, &tm_v, full_v + 8 * s, kBoxCols * c,
                   kvh, j * BC, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
    const int my_turn = 1 + wg, other_turn = 2 - wg;
    const int wg_row = q0 + 64 * wg;                     // the warpgroup's first row
    const int row0 = wg_row + 16 * warp + (lane >> 2);  // this thread's rows: row0, row0 + 8
    const int col0 = 2 * (lane & 3);                     // and columns col0, col0 + 1 of each 8

    float o[kPVs][kPV / 2];
#pragma unroll
    for (int c = 0; c < kPVs; ++c)
#pragma unroll
      for (int i = 0; i < kPV / 2; ++i) o[c][i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    float sc[kS];
    uint32_t p[BC / 16][4];  // P of the previous tile as the A fragments of its P V product
    uint32_t p_lo[kSplitP ? BC / 16 : 1][4];  // and, split, what bf16 rounding left of it

    // O += P V_j, issued asynchronously (one commit group); O was rescaled to
    // tile j's running max when P was made, so no other instruction touches
    // an accumulator between the two products of a turn.  V is MN-major: the
    // leading offset steps from one box (atom column) to the next along N
    auto issue_pv = [&](int j) {
      const int s = j % kStages;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
        for (int c = 0; c < kPVs; ++c) {
          const uint64_t db = desc_sw<kBoxBytes>(
              v_s + s * kTileBytes + (c * kPV / kBoxCols) * BC * kBoxBytes + kk * 16 * kBoxBytes,
              BC * kBoxBytes, kAtom);
          wgmma_rs(o[c], p[kk], db);
          if constexpr (kSplitP) wgmma_rs(o[c], p_lo[kk], db);
        }
      wgmma_commit();
    };

    // S = Q K_j^T: 64 x BC a warpgroup, K = D in steps of 16 (one commit group)
    auto issue_s = [&](int j) {
      const int s = j % kStages;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / kSteps, off = 32 * (kk % kSteps);
        const uint64_t da = desc_sw<kBoxBytes>(
            q_s + c * kRows * kBoxBytes + wg * 64 * kBoxBytes + off, 16, kAtom);
        const uint64_t db =
            desc_sw<kBoxBytes>(k_s + s * kTileBytes + c * BC * kBoxBytes + off, 16, kAtom);
        wgmma_ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
    };

    // online softmax of S_j in place, on the accumulator's layout: register
    // 4n + 2r + e holds row row0 + 8r, key j * BC + 8n + col0 + e; leaves P
    // (as floats) in sc and the rescale of the running sums in alpha.  m is
    // the running max of the unscaled scores (masked ones are -1e30), and
    // p = 2^(s log2(e) / sqrt(D) - m log2(e) / sqrt(D)) is one FFMA and one ex2
    float alpha[2];
    auto softmax = [&](int j) {
      const int k0 = j * BC;
      // causal: the tile straddles the warpgroup's diagonal; either mode: it
      // runs past T (the TMA unit filled its rows past T with zeros)
      const bool diag = causal && k0 + BC - 1 > wg_row;
      const bool ragged = k0 + BC > T;
      float mx[2] = {m[0], m[1]}, sum[2] = {0.0f, 0.0f}, ms[2];
      if (diag || ragged) {
#pragma unroll
        for (int n = 0; n < BC / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + 8 * n + col0 + (i & 1);
            if ((diag && key > row0 + 8 * (i >> 1)) || key >= T) sc[4 * n + i] = kNegInf;
          }
      }
#pragma unroll
      for (int i = 0; i < kS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
        m[r] = mx[r];
        ms[r] = mx[r] * scale_log2;
      }
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -ms[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
    };

    // P to bf16 A fragments, and O rescaled to the new running max, both
    // while no product is in flight
    auto to_p = [&]() {
#pragma unroll
      for (int n = 0; n < BC / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float x0 = sc[4 * n + 2 * r], x1 = sc[4 * n + 2 * r + 1];
          p[n / 2][2 * (n % 2) + r] = pack_bf16(x0, x1);
          if constexpr (kSplitP) {
            const float2 h = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&p[n / 2][2 * (n % 2) + r]));
            p_lo[n / 2][2 * (n % 2) + r] = pack_bf16(x0 - h.x, x1 - h.y);
          }
        }
#pragma unroll
      for (int c = 0; c < kPVs; ++c) {
#pragma unroll
        for (int i = 0; i < kPV / 2; ++i) o[c][i] *= alpha[(i >> 1) & 1];
        fence_regs(o[c]);
      }
    };

    // Both warpgroups walk every key tile of the block, so that no branch
    // that differs between them holds a wgmma in flight (ptxas would then
    // serialize them all): at 64-key tiles, warpgroup 0's last tile lies
    // wholly above its diagonal, is masked to -1e30 and adds nothing.  The
    // first tile is peeled, so that every turn of the loop commits the same
    // two groups.
    if (wg == 1) turn_pass(1);  // warpgroup 0 takes the first turn
    mbar_wait(bar_q, 0);
    mbar_wait(full_k, 0);
    turn_wait(my_turn);
    issue_s(0);
    turn_pass(other_turn);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(empty_k);  // K_0 is read
    softmax(0);
    to_p();
    for (int j = 1; j < n_kv; ++j) {
      const int s = j % kStages, sp = (j - 1) % kStages;
      mbar_wait(full_k + 8 * s, (j / kStages) & 1);
      mbar_wait(full_v + 8 * sp, ((j - 1) / kStages) & 1);
      turn_wait(my_turn);
      issue_s(j);
      issue_pv(j - 1);
      turn_pass(other_turn);
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
      fence_regs(sc);
      mbar_arrive(empty_k + 8 * s);  // K_j is read
      softmax(j);
      wgmma_wait<0>();  // P_{j-1} V_{j-1} is done: its registers are free
#pragma unroll
      for (int c = 0; c < kPVs; ++c) fence_regs(o[c]);
      mbar_arrive(empty_v + 8 * sp);  // V_{j-1} is read
      to_p();
    }
    mbar_wait(full_v + 8 * ((n_kv - 1) % kStages), ((n_kv - 1) / kStages) & 1);
    turn_wait(my_turn);  // the last turn: P V of the last tile
    issue_pv(n_kv - 1);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kPVs; ++c) fence_regs(o[c]);
    if (wg == 0) turn_pass(other_turn);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
      if (row >= S) continue;  // rows past a ragged S are never written
      if (lse != nullptr && (lane & 3) == 0)
        lse[((long long)b * H + h) * S + row] = (m[r] * scale_log2 + log2f(denom)) * kLn2;
      __nv_bfloat16* dst = out + (((long long)b * S + row) * H + h) * D + col0;
#pragma unroll
      for (int c = 0; c < kPVs; ++c)
#pragma unroll
        for (int n = 0; n < kPV / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(dst + kPV * c + 8 * n) =
              __floats2bfloat162_rn(o[c][4 * n + 2 * r] / denom, o[c][4 * n + 2 * r + 1] / denom);
    }
  }
}

template <int D, bool kSplitP>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S, int T,
           int H, int Hkv, float scale, int causal, int smem, cudaStream_t stream) {
  constexpr int BC = key_tile(D);
  if (smem < smem_bytes(D)) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, B, S, H, D, kRows, box_cols(D)) ||
      !make_map(encode, &tk, k, B, T, Hkv, D, BC, box_cols(D)) ||
      !make_map(encode, &tv, v, B, T, Hkv, D, BC, box_cols(D)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      prefill_wgmma_kernel<D, BC, kSplitP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_q = (S + kRows - 1) / kRows;
  prefill_wgmma_kernel<D, BC, kSplitP><<<dim3(n_q, H, B), kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, S, T, H, Hkv, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

}  // namespace wg

// bf16 q (B, S, H, D), k and v (B, T, Hkv, D), out (B, S, H, D), contiguous and
// 16-byte aligned; lse (B, H, S) float32, or null; D in {64, 96, 128, 192, 256};
// causal needs T == S; smem_bytes from kernel.py's prefill_plan (at least
// wg::smem_bytes(D)); split_p: P enters P V as bf16 hi + lo (training).
extern "C" int repro_flash_prefill_wgmma(const void* q, const void* k, const void* v, void* out,
                                         void* lse, int B, int S, int T, int H, int Hkv, int D,
                                         float scale, int causal, int smem_bytes, int split_p,
                                         void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (T <= 0 || (causal && T != S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define REPRO_WG(DIM)                                                                     \
  (split_p ? wg::launch<DIM, true>(q, k, v, out, l, B, S, T, H, Hkv, scale, causal, smem_bytes, st) \
           : wg::launch<DIM, false>(q, k, v, out, l, B, S, T, H, Hkv, scale, causal, smem_bytes, st))
  switch (D) {
    case 64: return REPRO_WG(64);
    case 96: return REPRO_WG(96);
    case 128: return REPRO_WG(128);
    case 192: return REPRO_WG(192);
    case 256: return REPRO_WG(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_WG
}
