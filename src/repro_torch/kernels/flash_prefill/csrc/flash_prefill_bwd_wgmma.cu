// The gradient of GQA flash attention in bf16 on Hopper's wgmma and TMA: dQ, dK and dV in
// three launches.
//
// Replaces no Pallas kernel: the reference trains through JAX's autodiff of
// its jnp flash_attention (src/repro/models/attention.py:67-159).  This is
// the Hopper design of flash_prefill_bwd.cu's gradient, by the same textbook
// formulas, from q, k, v, the forward's output o, its gradient dO and the
// forward's float32 log-sum-exp (lse):
//
//   P = exp(Q K^T / sqrt(D) - lse),  dV = P^T dO,  dP = dO V^T,
//   delta_i = sum_d dO_id O_id,  dS = P (dP - delta),
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),
//
// with P = 0 above the diagonal (causal) and past a ragged S or T.  bf16 at
// D in {64, 96, 128} (kernel.py::bwd_design); float32 accumulation; P and
// dS rounded to bf16 for their products (as the mma.sync design it
// replaced rounded them); dq, dk and dv rounded once to bf16.
//
// Bound on an H100: operations.  Five products of 2 S T D a (b, h) (halved
// where causal) over the bf16 tensor-core peak of 989 TFLOP/s: at glm4-9b's
// training microbatch, B=2, H=32, S=T=4096, D=128, causal, 6.87e11
// operations, 0.69 ms.  This design computes S and dP in both of its first
// two launches (7 products, 0.97 ms), the cost of a dQ without atomics, and
// moves float32 partial dK and dV through device memory (below).
//
// Three launches, and no floating-point atomics, so two runs give the same
// bits: the order of every sum is fixed by the loops.
//
//   1. dq_kernel, a block a (128-row query tile, query head, batch), the
//      longest tiles first: one producer warpgroup issues TMA loads of the
//      tile's Q and dO (once) and of every key tile's K and V (BC keys) into
//      a ring of ST stages; two consumer warpgroups of 64 rows
//      each first take delta of their rows from o and dO (written for launch
//      2), then walk the key tiles up to the diagonal in order:
//        S = Q K^T, dP = dO V^T   wgmma, A and B from shared memory (K-major);
//        dS = P (dP - delta)      in registers, P = 2^(S log2(e)/sqrt(D) - lse log2(e));
//        dQ += dS K               wgmma, dS from registers (rounded to bf16),
//                                 K read MN-major (the forward's P V form).
//      S and dP of tile j + 1 are issued before dQ += dS_j K_j, so the exp2
//      work of tile j + 1 runs while that product does.
//   2. dkv_kernel, a block a (128-key tile, group of hg query heads, batch),
//      the smallest key tiles (the most query tiles, where causal) first: the
//      producer loads K and V once and, for each head of the group in order
//      and each 64-row query tile from the diagonal on in order, Q and dO
//      by TMA into a ring, while a second producer warp copies the tile's
//      lse (times log2(e)) and delta into the same stage; each consumer
//      warpgroup owns 64 keys:
//        S^T = K Q^T, dP^T = V dO^T   from shared memory;
//        P^T, dS^T                    in registers;
//        dV += P^T dO, dK += dS^T Q   A from registers, dO and Q MN-major.
//      A step's products run in turn: dK and dV (128 floats a thread at D =
//      128) leave no room to hold step t's P^T and dS^T fragments while step
//      t + 1's S^T and dP^T arrive (ptxas spilled 208 bytes and serialized
//      the wgmmas, and the call ran 12% slower at glm4-9b); the two
//      warpgroups' steps overlap each other instead.  The block writes its
//      group's float32 partial dK and dV, (B, T, H / hg, D), so no block
//      walks all g = H / Hkv query heads of a KV head: at glm4-9b (g = 16)
//      the sweep chose hg = 8, 256 blocks and two partials a KV head (hg =
//      16 ran 1.5x slower, hg = 2 and 4 2-3%).
//   3. dkv_sum_kernel: dk = scale * sum of a KV head's g / hg partials in head
//      order, dv the same without the scale, each rounded once to bf16.
//
// Two consumer warpgroups and one producer warpgroup a block (setmaxnreg:
// 240 and 24 registers a thread), one block an SM.  The tiles are (B, S,
// heads, D) bf16 tensors read through 4-D tensor maps with 64-column boxes
// under the 128-byte swizzle, or at D = 96 (phi-3-vision) three 32-column
// boxes under the 64-byte swizzle, the products into dQ, dK and dV then one
// m64n96 each whose MN-major B walks the three boxes, as in the forward's
// wgmma design (kernels/csrc/hopper.cuh holds the helpers both use); rows
// past S or T arrive as zeros and are masked.
// No branch that differs between the threads of a warpgroup holds a wgmma in
// flight, and every turn of a loop commits the same groups (the last step
// is peeled), or ptxas serializes the wgmmas.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../csrc/hopper.cuh"

// The plans (dQ key tile, dQ stages, dK/dV stages) this library holds;
// tools/time_flash_bwd_designs.py --sweep builds it with more.
#ifndef BWD_WG_PLANS
#define BWD_WG_PLANS X(64, 4, 2)
#endif

namespace {

using namespace hopper;

constexpr int kConsumers = 256;             // the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
// Registers a thread after setmaxnreg: the producer gives its registers to
// the consumers (128 x 24 + 256 x 240 <= 65 536).
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// Columns of a TMA box and of a swizzle atom's row: 64 (128 bytes, the
// 128-byte swizzle) where D is a multiple of 64, else 32 (64 bytes, the
// 64-byte swizzle: D = 96 is three boxes), as the forward's wgmma design.
__host__ __device__ constexpr int box_cols(int D) { return D % 64 == 0 ? 64 : 32; }
// N of one product into a D-wide accumulator (dQ, dK, dV): a 64-column box
// at D % 64 == 0, the whole row (96) otherwise, its MN-major B striding
// across the boxes by the descriptor's leading offset.
__host__ __device__ constexpr int pv_cols(int D) { return D % 64 == 0 ? 64 : D; }
constexpr int kRows = 128;  // query rows of a dQ block, keys of a dK/dV block: 64 a warpgroup
constexpr int kQ = 64;      // query rows of a dK/dV step
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block, 1024 bytes of it to align the swizzled tiles.
// kernel.py's bwd_plan computes the same figures and passes them in.
constexpr int dq_smem(int D, int BC, int ST) {
  return 1024 + 2 * kRows * D * 2 + ST * 2 * BC * D * 2 + kRows * 4 + 8 * (1 + 2 * ST);
}
constexpr int dkv_smem(int D, int ST) {
  return 1024 + 2 * kRows * D * 2 + ST * (2 * kQ * D * 2 + 2 * kQ * 4) + 8 * (1 + 2 * ST);
}

// A warpgroup's named barrier (ids 1 and 2), its 128 threads only.
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The A fragments (bf16, k-steps of 16 columns) of a 64 x N float32
// accumulator: register 4n + 2r + e holds row 8r + (lane / 4) of the warp's
// 16, column 8n + 2 (lane % 4) + e.
template <int N>
__device__ __forceinline__ void to_frags(const float (&acc)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      a[n / 2][2 * (n % 2) + r] = pack_bf16(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
}

// Launch 1.  D: head dimension (64, 96 or 128); BC: keys of a tile; ST: stages of
// the K/V ring.
template <int D, int BC, int ST>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
          const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
          const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int B, int S, int T, int H, int Hkv, float scale,
          float scale_log2, int causal) {
  constexpr int kBoxCols = box_cols(D), kBoxBytes = 2 * kBoxCols, kBoxes = D / kBoxCols;
  constexpr int kAtom = 8 * kBoxBytes;    // 8 swizzled rows: the descriptors' stride offset
  constexpr int kSteps = kBoxCols / 16;   // k-steps of 16 columns a box
  constexpr int kPV = pv_cols(D), kPVs = D / kPV;
  constexpr int kQBytes = kRows * D * 2;  // the Q tile, and the dO tile
  constexpr int kTileBytes = BC * D * 2;  // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + kQBytes;
  const uint32_t k_s = do_s + kQBytes;               // stage s at k_s + s * kTileBytes
  const uint32_t v_s = k_s + ST * kTileBytes;        // stage s at v_s + s * kTileBytes
  const uint32_t dl_addr = v_s + ST * kTileBytes;    // delta of the tile's rows: kRows floats
  const uint32_t bar_once = dl_addr + kRows * 4;     // Q and dO; then full and empty a stage
  const uint32_t full = bar_once + 8, empty = full + 8 * ST;
  float* dl_s = reinterpret_cast<float*>(smem_raw + (dl_addr - smem_u32(smem_raw)));

  const int n_q = (S + kRows - 1) / kRows;
  const int id = blockIdx.x;
  const int qi = n_q - 1 - id / (H * B);  // the longest query tiles first
  const int h = id % H, b = id / H % B;
  const int kvh = h / (H / Hkv);
  const int q0 = qi * kRows;
  // causal: key tiles up to the block's last row, within S; else all of T
  const int n_kv = causal ? min((q0 + kRows + BC - 1) / BC, (S + BC - 1) / BC) : (T + BC - 1) / BC;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_once, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      mbar_expect_tx(bar_once, 2 * kQBytes);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        tma_load(q_s + c * kRows * kBoxBytes, &tm_q, bar_once, kBoxCols * c, h, q0, b);
        tma_load(do_s + c * kRows * kBoxBytes, &tm_do, bar_once, kBoxCols * c, h, q0, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % ST, round = j / ST;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * kTileBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          tma_load(k_s + s * kTileBytes + c * BC * kBoxBytes, &tm_k, full + 8 * s, kBoxCols * c,
                   kvh, j * BC, b);
          tma_load(v_s + s * kTileBytes + c * BC * kBoxBytes, &tm_v, full + 8 * s, kBoxCols * c,
                   kvh, j * BC, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  const int wg_row = q0 + 64 * wg;                    // the warpgroup's first row
  const int row0 = wg_row + 16 * warp + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane & 3);                    // and columns col0, col0 + 1 of each 8

  {  // delta of the warpgroup's 64 rows: 2 threads a row, each half the columns in order
    const int r = (tid & 127) >> 1, half = tid & 1, row = wg_row + r;
    float sum = 0.0f;
    if (row < S) {
      const long long at = (((long long)b * S + row) * H + h) * D + half * (D / 2);
#pragma unroll 4
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + at + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + at + c);
        const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(oh[e]), y = __bfloat1622float2(dh[e]);
          sum = fmaf(y.x, x.x, sum);
          sum = fmaf(y.y, x.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      dl_s[64 * wg + r] = sum;
      if (row < S) delta[((long long)b * H + h) * S + row] = sum;
    }
  }
  wg_sync(wg);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < S ? lse[((long long)b * H + h) * S + row] * kLog2e : 0.0f;
    dl[r] = dl_s[row - q0];
  }

  float acc[kPVs][kPV / 2];  // dQ: 64 rows x D a warpgroup, kPV columns a fragment
#pragma unroll
  for (int c = 0; c < kPVs; ++c)
#pragma unroll
    for (int i = 0; i < kPV / 2; ++i) acc[c][i] = 0.0f;
  float sc[BC / 2], dp[BC / 2];  // S then dS, and dP: 64 rows x BC keys
  uint32_t ds[BC / 16][4];       // dS of the previous tile as A fragments

  // S = Q K_j^T and dP = dO V_j^T, one commit group
  auto issue_sdp = [&](int j) {
    const int s = j % ST;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / kSteps, off = 32 * (kk % kSteps);
      wgmma_ss(sc, desc_sw<kBoxBytes>(q_s + c * kRows * kBoxBytes + wg * 64 * kBoxBytes + off, 16,
                                      kAtom),
               desc_sw<kBoxBytes>(k_s + s * kTileBytes + c * BC * kBoxBytes + off, 16, kAtom),
               kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / kSteps, off = 32 * (kk % kSteps);
      wgmma_ss(dp, desc_sw<kBoxBytes>(do_s + c * kRows * kBoxBytes + wg * 64 * kBoxBytes + off,
                                      16, kAtom),
               desc_sw<kBoxBytes>(v_s + s * kTileBytes + c * BC * kBoxBytes + off, 16, kAtom),
               kk > 0);
    }
    wgmma_commit();
  };

  // dQ += dS_j K_j: the keys are the depth, K MN-major (the leading offset
  // steps from one box to the next along N)
  auto issue_dq = [&](int j) {
    const int s = j % ST;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kPVs; ++c)
        wgmma_rs(acc[c], ds[kk],
                 desc_sw<kBoxBytes>(k_s + s * kTileBytes + (c * kPV / kBoxCols) * BC * kBoxBytes +
                                        kk * 16 * kBoxBytes,
                                    BC * kBoxBytes, kAtom));
    wgmma_commit();
  };

  // dS = P (dP - delta) in sc, P = 0 where masked
  auto grads = [&](int j) {
    const int k0 = j * BC;
    const bool diag = causal && k0 + BC - 1 > wg_row;  // a key past some row of the warpgroup
    const bool ragged = k0 + BC > T;
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, key = k0 + 8 * n + col0 + (i & 1);
        float p = fast_exp2(fmaf(sc[4 * n + i], scale_log2, -lse2[r]));
        if ((diag || ragged) && ((causal && key > row0 + 8 * r) || key >= T)) p = 0.0f;
        sc[4 * n + i] = p * (dp[4 * n + i] - dl[r]);
      }
  };

  mbar_wait(bar_once, 0);
  mbar_wait(full, 0);
  issue_sdp(0);
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  grads(0);
  to_frags<BC>(sc, ds);
  for (int j = 0; j + 1 < n_kv; ++j) {
    const int sn = (j + 1) % ST;
    mbar_wait(full + 8 * sn, ((j + 1) / ST) & 1);
    issue_sdp(j + 1);
    issue_dq(j);
    wgmma_wait<1>();  // S and dP of tile j + 1 are done; dS_j K_j may still run
    fence_regs(sc);
    fence_regs(dp);
    grads(j + 1);
    wgmma_wait<0>();  // dS_j K_j is done: K_j, V_j and the fragments are free
#pragma unroll
    for (int c = 0; c < kPVs; ++c) fence_regs(acc[c]);
    mbar_arrive(empty + 8 * (j % ST));
    to_frags<BC>(sc, ds);
  }
  issue_dq(n_kv - 1);
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kPVs; ++c) fence_regs(acc[c]);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;  // rows past a ragged S are never written
    __nv_bfloat16* dst = dq + (((long long)b * S + row) * H + h) * D + col0;
#pragma unroll
    for (int c = 0; c < kPVs; ++c)
#pragma unroll
      for (int n = 0; n < kPV / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + kPV * c + 8 * n) = __floats2bfloat162_rn(
            acc[c][4 * n + 2 * r] * scale, acc[c][4 * n + 2 * r + 1] * scale);
  }
}

// Launch 2.  D: head dimension (64, 96 or 128); ST: stages of the Q/dO ring.
template <int D, int ST>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
           const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk_part, float* __restrict__ dv_part, int B, int S, int T, int H,
           int Hkv, int hg, float scale_log2, int causal) {
  constexpr int kBoxCols = box_cols(D), kBoxBytes = 2 * kBoxCols, kBoxes = D / kBoxCols;
  constexpr int kAtom = 8 * kBoxBytes;     // 8 swizzled rows: the descriptors' stride offset
  constexpr int kSteps = kBoxCols / 16;    // k-steps of 16 columns a box
  constexpr int kPV = pv_cols(D), kPVs = D / kPV;
  constexpr int kKVBytes = kRows * D * 2;  // the K tile, and the V tile
  constexpr int kStepBytes = kQ * D * 2;   // one Q or dO tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t k_s = (base + 1023u) & ~1023u;
  const uint32_t v_s = k_s + kKVBytes;
  const uint32_t q_s = v_s + kKVBytes;               // stage s at q_s + s * 2 kStepBytes
  const uint32_t stats = q_s + ST * 2 * kStepBytes;  // stage s: lse log2(e), then delta, kQ each
  const uint32_t bar_once = stats + ST * 2 * kQ * 4;  // K and V; then full and empty a stage
  const uint32_t full = bar_once + 8, empty = full + 8 * ST;
  const float* stats_s = reinterpret_cast<const float*>(smem_raw + (stats - base));

  const int n_groups = H / hg;  // partials of (b, key): a head group each
  const int id = blockIdx.x;
  const int kt = id / (n_groups * B);  // the smallest key tiles first
  const int grp = id % n_groups, b = id / n_groups % B;
  const int kvh = grp * hg / (H / Hkv);
  const int k0 = kt * kRows;
  const int n_qt = (S + kQ - 1) / kQ;
  const int qt0 = causal ? k0 / kQ : 0;  // causal: query tiles from the diagonal on
  const int per_head = n_qt - qt0;
  const int n_steps = hg * per_head;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_once, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1 + 32);  // the TMA thread and the stats warp
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {  // one thread issues every TMA load
      mbar_expect_tx(bar_once, 2 * kKVBytes);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        tma_load(k_s + c * kRows * kBoxBytes, &tm_k, bar_once, kBoxCols * c, kvh, k0, b);
        tma_load(v_s + c * kRows * kBoxBytes, &tm_v, bar_once, kBoxCols * c, kvh, k0, b);
      }
      for (int t = 0; t < n_steps; ++t) {
        const int s = t % ST, round = t / ST;
        const int h = grp * hg + t / per_head, q0 = (qt0 + t % per_head) * kQ;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * kStepBytes);
        const uint32_t qs = q_s + s * 2 * kStepBytes;
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          tma_load(qs + c * kQ * kBoxBytes, &tm_q, full + 8 * s, kBoxCols * c, h, q0, b);
          tma_load(qs + kStepBytes + c * kQ * kBoxBytes, &tm_do, full + 8 * s, kBoxCols * c, h,
                   q0, b);
        }
      }
    } else if (tid >= kConsumers + 32 && tid < kConsumers + 64) {  // the stats warp
      const int lane = tid & 31;
      float* st = reinterpret_cast<float*>(smem_raw + (stats - base));
      for (int t = 0; t < n_steps; ++t) {
        const int s = t % ST, round = t / ST;
        const int h = grp * hg + t / per_head, q0 = (qt0 + t % per_head) * kQ;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
#pragma unroll
        for (int e = 0; e < kQ / 32; ++e) {
          const int c = lane + 32 * e, row = q0 + c;
          const long long at = ((long long)b * H + h) * S + row;
          st[s * 2 * kQ + c] = row < S ? lse[at] * kLog2e : 0.0f;
          st[s * 2 * kQ + kQ + c] = row < S ? delta[at] : 0.0f;
        }
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  const int key_first = k0 + 64 * wg;                      // the warpgroup's first key
  const int key0 = key_first + 16 * warp + (lane >> 2);  // this thread's keys: key0, key0 + 8
  const int col0 = 2 * (lane & 3);                         // and query columns col0, col0 + 1

  float dk[kPVs][kPV / 2], dv[kPVs][kPV / 2];  // 64 keys x D a warpgroup
#pragma unroll
  for (int c = 0; c < kPVs; ++c)
#pragma unroll
    for (int i = 0; i < kPV / 2; ++i) dk[c][i] = dv[c][i] = 0.0f;
  float sc[kQ / 2], dp[kQ / 2];     // S^T then P^T, and dP^T then dS^T: 64 keys x 64 queries
  uint32_t pf[kQ / 16][4], dsf[kQ / 16][4];  // P^T and dS^T as A fragments

  // S^T = K Q_t^T and dP^T = V dO_t^T, one commit group
  auto issue_sdp = [&](int t) {
    const uint32_t qs = q_s + (t % ST) * 2 * kStepBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / kSteps, off = 32 * (kk % kSteps);
      wgmma_ss(sc, desc_sw<kBoxBytes>(k_s + c * kRows * kBoxBytes + wg * 64 * kBoxBytes + off, 16,
                                      kAtom),
               desc_sw<kBoxBytes>(qs + c * kQ * kBoxBytes + off, 16, kAtom), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / kSteps, off = 32 * (kk % kSteps);
      wgmma_ss(dp, desc_sw<kBoxBytes>(v_s + c * kRows * kBoxBytes + wg * 64 * kBoxBytes + off, 16,
                                      kAtom),
               desc_sw<kBoxBytes>(qs + kStepBytes + c * kQ * kBoxBytes + off, 16, kAtom), kk > 0);
    }
    wgmma_commit();
  };

  // dV += P^T dO_t and dK += dS^T Q_t: the queries are the depth, dO and Q MN-major
  auto issue_kv = [&](int t) {
    const uint32_t qs = q_s + (t % ST) * 2 * kStepBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kPVs; ++c) {
        const uint32_t at = (c * kPV / kBoxCols) * kQ * kBoxBytes + kk * 16 * kBoxBytes;
        wgmma_rs(dv[c], pf[kk], desc_sw<kBoxBytes>(qs + kStepBytes + at, kQ * kBoxBytes, kAtom));
        wgmma_rs(dk[c], dsf[kk], desc_sw<kBoxBytes>(qs + at, kQ * kBoxBytes, kAtom));
      }
    wgmma_commit();
  };

  // P^T in sc and dS^T = P^T (dP^T - delta) in dp, 0 where masked
  auto grads = [&](int t) {
    const int s = t % ST, q0 = (qt0 + t % per_head) * kQ;
    const float* l2 = stats_s + s * 2 * kQ;
    const float* dl = l2 + kQ;
    const bool diag = causal && key_first + 63 > q0;  // a key past some query of the tile
    const bool ragged = key_first + 64 > T || q0 + kQ > S;
#pragma unroll
    for (int n = 0; n < kQ / 8; ++n) {
      const float2 lv = *reinterpret_cast<const float2*>(l2 + 8 * n + col0);
      const float2 dv2 = *reinterpret_cast<const float2*>(dl + 8 * n + col0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, e = i & 1, query = q0 + 8 * n + col0 + e, key = key0 + 8 * r;
        float p = fast_exp2(fmaf(sc[4 * n + i], scale_log2, -(e ? lv.y : lv.x)));
        if ((diag || ragged) && ((causal && key > query) || key >= T || query >= S)) p = 0.0f;
        sc[4 * n + i] = p;
        dp[4 * n + i] = p * (dp[4 * n + i] - (e ? dv2.y : dv2.x));
      }
    }
  };

  mbar_wait(bar_once, 0);
  for (int t = 0; t < n_steps; ++t) {
    const int s = t % ST;
    mbar_wait(full + 8 * s, (t / ST) & 1);
    issue_sdp(t);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    grads(t);
    to_frags<kQ>(sc, pf);
    to_frags<kQ>(dp, dsf);
    issue_kv(t);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kPVs; ++c) {
      fence_regs(dk[c]);
      fence_regs(dv[c]);
    }
    mbar_arrive(empty + 8 * s);
  }

  // the group's float32 partials, (B, T, H / hg, D); keys past T are never written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= T) continue;
    const long long at = (((long long)b * T + key) * n_groups + grp) * D + col0;
#pragma unroll
    for (int c = 0; c < kPVs; ++c)
#pragma unroll
      for (int n = 0; n < kPV / 8; ++n) {
        const int i = 4 * n + 2 * r, d = kPV * c + 8 * n;
        *reinterpret_cast<float2*>(dk_part + at + d) = make_float2(dk[c][i], dk[c][i + 1]);
        *reinterpret_cast<float2*>(dv_part + at + d) = make_float2(dv[c][i], dv[c][i + 1]);
      }
  }
}

constexpr int kSumThreads = 256;

// Launch 3: a thread 8 columns of one (b, key, KV head); the KV head's
// n_part partials summed in head order, rounded once to bf16.
__global__ void __launch_bounds__(kSumThreads)
dkv_sum_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, long long n_threads,
           int Hkv, int n_part, int D, float scale) {
  const long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= n_threads) return;
  const int cols = D / 8;
  const long long row = i / cols;  // (b, key, KV head)
  const int d = (int)(i % cols) * 8;
  const float* pk = dk_part + row * n_part * D + d;  // (b, key) rows hold Hkv * n_part partials
  const float* pv = dv_part + row * n_part * D + d;
  float a[8], c[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) a[e] = c[e] = 0.0f;
  for (int p = 0; p < n_part; ++p) {
    const float4 k0 = *reinterpret_cast<const float4*>(pk + (long long)p * D);
    const float4 k1 = *reinterpret_cast<const float4*>(pk + (long long)p * D + 4);
    const float4 v0 = *reinterpret_cast<const float4*>(pv + (long long)p * D);
    const float4 v1 = *reinterpret_cast<const float4*>(pv + (long long)p * D + 4);
    a[0] += k0.x, a[1] += k0.y, a[2] += k0.z, a[3] += k0.w;
    a[4] += k1.x, a[5] += k1.y, a[6] += k1.z, a[7] += k1.w;
    c[0] += v0.x, c[1] += v0.y, c[2] += v0.z, c[3] += v0.w;
    c[4] += v1.x, c[5] += v1.y, c[6] += v1.z, c[7] += v1.w;
  }
  uint4 ok, ov;
  uint32_t* wk = reinterpret_cast<uint32_t*>(&ok);
  uint32_t* wv = reinterpret_cast<uint32_t*>(&ov);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    wk[e] = pack_bf16(a[2 * e] * scale, a[2 * e + 1] * scale);
    wv[e] = pack_bf16(c[2 * e], c[2 * e + 1]);
  }
  *reinterpret_cast<uint4*>(dk + row * D + d) = ok;
  *reinterpret_cast<uint4*>(dv + row * D + d) = ov;
}

template <int D, int BC, int ST1, int ST2>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, float* dk_part,
           float* dv_part, int B, int S, int T, int H, int Hkv, int hg, float scale, int causal,
           int smem1, int smem2, cudaStream_t stream) {
  if (smem1 < dq_smem(D, BC, ST1) || smem2 < dkv_smem(D, ST2)) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap q1, do1, k1, v1, q2, do2, k2, v2;
  constexpr int cols = box_cols(D);
  if (!make_map(encode, &q1, q, B, S, H, D, kRows, cols) ||
      !make_map(encode, &do1, dout, B, S, H, D, kRows, cols) ||
      !make_map(encode, &k1, k, B, T, Hkv, D, BC, cols) ||
      !make_map(encode, &v1, v, B, T, Hkv, D, BC, cols) ||
      !make_map(encode, &q2, q, B, S, H, D, kQ, cols) ||
      !make_map(encode, &do2, dout, B, S, H, D, kQ, cols) ||
      !make_map(encode, &k2, k, B, T, Hkv, D, kRows, cols) ||
      !make_map(encode, &v2, v, B, T, Hkv, D, kRows, cols))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(dq_kernel<D, BC, ST1>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dkv_kernel<D, ST2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (e != cudaSuccess) return (int)e;
  using bf = __nv_bfloat16;
  const float scale_log2 = scale * kLog2e;
  const int n_q = (S + kRows - 1) / kRows;
  dq_kernel<D, BC, ST1><<<n_q * H * B, kThreads, smem1, stream>>>(
      q1, do1, k1, v1, static_cast<const bf*>(o), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dq), B, S, T, H, Hkv, scale, scale_log2, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_kt = (T + kRows - 1) / kRows;
  dkv_kernel<D, ST2><<<n_kt * (H / hg) * B, kThreads, smem2, stream>>>(
      q2, do2, k2, v2, lse, delta, dk_part, dv_part, B, S, T, H, Hkv, hg, scale_log2, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_threads = (long long)B * T * Hkv * (D / 8);
  dkv_sum_kernel<<<(unsigned)((n_threads + kSumThreads - 1) / kSumThreads), kSumThreads, 0, stream>>>(
      dk_part, dv_part, static_cast<bf*>(dk), static_cast<bf*>(dv), n_threads, Hkv,
      H / Hkv / hg, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, o, dout and dq (B, S, H, D), k, v, dk and dv (B, T, Hkv, D), contiguous and
// 16-byte aligned; lse (B, H, S) float32 from the forward; delta (B, H, S) float32
// scratch that launch 1 writes and launch 2 reads; dk_part and dv_part (B, T, H / hg, D)
// float32 scratch; D in {64, 96, 128}; causal needs T == S; hg query heads a dK/dV block, a
// divisor of H / Hkv; the plan (dq_keys, dq_stages, dkv_stages) one of BWD_WG_PLANS and
// the shared memory of each launch from kernel.py's bwd_plan.
extern "C" int repro_flash_prefill_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    void* delta, void* dq, void* dk, void* dv, void* dk_part, void* dv_part, int B, int S, int T,
    int H, int Hkv, int D, float scale, int causal, int hg, int dq_keys, int dq_stages,
    int dkv_stages, int smem1, int smem2, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (T <= 0 || (causal && T != S) || Hkv <= 0 || H % Hkv || hg <= 0 || (H / Hkv) % hg)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* pk = static_cast<float*>(dk_part);
  float* pv = static_cast<float*>(dv_part);
#define X(BC, ST1, ST2)                                                                       \
  if (dq_keys == BC && dq_stages == ST1 && dkv_stages == ST2)                                 \
    return launch<DIM, BC, ST1, ST2>(q, k, v, o, dout, l, dl, dq, dk, dv, pk, pv, B, S, T, H, \
                                     Hkv, hg, scale, causal, smem1, smem2, st);
  if (D == 64) {
    constexpr int DIM = 64;
    BWD_WG_PLANS
  } else if (D == 96) {
    constexpr int DIM = 96;
    BWD_WG_PLANS
  } else if (D == 128) {
    constexpr int DIM = 128;
    BWD_WG_PLANS
  }
#undef X
  return (int)cudaErrorInvalidValue;
}
