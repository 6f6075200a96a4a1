#!/usr/bin/env python3
"""The attention backward's wgmma design beside its mma.sync design, and the sweep of its plans, on one card.

    python3 tools/time_flash_bwd_designs.py            # both designs in turns at every bf16 case
    python3 tools/time_flash_bwd_designs.py --sweep    # every candidate plan and head group

Run from the root of a checkout.  ``csrc/flash_prefill_bwd_wgmma.cu`` (dQ
over 128-row query tiles, then float32 partial dK and dV over 128-key tiles
a group of query heads, then their sum in head order; the products on
wgmma from TMA rings) replaced, at bf16 D in {64, 96, 128}, the ``mma.sync``
design of ``csrc/flash_prefill_bwd.cu`` (dQ over 64-row query tiles, dK and
dV over 64-key tiles, a block walking every query head of its KV head one
after another in 32-row steps, tiles staged by plain loads).  That design
is kept here as text (``EARLIER``) and built into
``build/repro_torch/earlier/`` (:func:`earlier_bwd`).

:func:`time_designs` runs chip_smoke.py's phase 28 (a) at every bf16 case of
``BWD_CASES`` (``chip_smoke.check_bwd_case``: the kernel against the plain
version, two runs bit for bit, the CUDA-core and earlier designs' errors,
and :func:`time_in_turns`: the wgmma design and the earlier one cold, in
the order new, old, old, new), beside the card's bound (five
products), the design's own bound (:func:`own_bound`: seven products and
the partials' traffic), the plain version, SDPA's backward and the floor of
the timing (:func:`floor_ms`), and where each of the three launches' time
goes at glm4-9b's case (:func:`parts`, from torch.profiler).

:func:`sweep` builds ``csrc/flash_prefill_bwd_wgmma.cu`` once more with
every plan of ``SWEEP`` (``BWD_WG_PLANS`` defined), holds each against the
plain version on short inputs (bit for bit on repeat), times it cold at
glm4-9b's training microbatch at every head group of ``HEAD_GROUPS``, and
prints ptxas's registers and spills of each kernel: the sweep that chose
``kernel.BWD_DQ_KEYS``, ``BWD_DQ_STAGES``, ``BWD_DKV_STAGES`` and
``BWD_HEAD_GROUP``.

Alone, the script prints the card and its power limit first and a JSON
line last.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import re
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402

REPS = 3
#: what the earlier design does
EARLIER_DESIGN = ("mma.sync m16n8k16 from ldmatrix, 4 warps a block; dQ a block a 64-row "
                  "query tile; dK and dV a block a 64-key tile and KV head, walking its g query "
                  "heads in turn in 32-row steps; tiles staged by plain loads between barriers")
#: the plans the sweep builds: (dQ key tile, dQ stages, dK/dV stages)
SWEEP = ((64, 4, 2), (64, 3, 2), (64, 2, 2), (64, 4, 3), (64, 4, 4), (128, 2, 2))
#: query heads a dK/dV block, swept at every plan (glm4-9b: g = 16)
HEAD_GROUPS = (2, 4, 8, 16)
#: the short inputs each plan is held to the plain version on: (B, S, T, H, Hkv, D, causal)
SWEEP_CHECKS = ((2, 129, 129, 32, 2, 128, True), (2, 37, 150, 8, 2, 64, False),
                (1, 200, 200, 16, 1, 128, True), (1, 150, 150, 8, 4, 96, False))
GLM4 = smoke.BWD_CASES[0]
#: ``csrc/flash_prefill_bwd.cu``'s mma.sync design, as it was
EARLIER = r"""// csrc/flash_prefill_bwd.cu's mma.sync design as it was before the wgmma
// design replaced it at bf16 D in {64, 96, 128} (kept as text by
// tools/time_flash_bwd_designs.py, its entry point renamed
// repro_flash_prefill_bwd_earlier).
//
// The gradient of GQA flash attention in two launches, no atomics:
//   1. dq_kernel, a block a (64-row query tile, query head, batch): delta of
//      its rows (written for launch 2), then every key tile up to the
//      diagonal (all of T where not causal) in order: S and dP, dS, and
//      dQ += dS K;
//   2. dkv_kernel, a block a (64-key tile, KV head, batch): its g query heads
//      in order, and for each every query tile from the diagonal on in
//      order: S^T and dP^T, then dV += P^T dO and dK += dS^T Q, in registers.
// The products on the tensor cores, mma.sync m16n8k16 bf16 with float32
// accumulators, 4 warps a block.  A dQ block's warp owns 16 query rows, a
// dK/dV block's warp 16 keys (query tiles of 32 rows there, so that dK, dV,
// S^T and dP^T fit 238 registers at D = 128).  Tiles are staged as bf16 rows
// of D + 8 (16-byte loads; the padding spreads ldmatrix's rows over the
// banks); A and B fragments come by ldmatrix, the products' second operands
// that must be read transposed by ldmatrix.trans; P and dS never leave
// registers, rounded to bf16 as the next product's A fragment.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
extern "C" int repro_flash_prefill_bwd_earlier(const void* q, const void* k, const void* v,
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
"""


def own_bound(B, S, T, H, Hkv, D, causal, hg):
    """The wgmma design's own least time: seven products of 2 D a kept
    (query head, query, key) pair (S and dP in both of its first two
    launches) over the bf16 peak, plus its float32 partials of dK and dV,
    (B, T, H / hg, D) each, written and read back once at the HBM rate."""
    pairs = S * (S + 1) // 2 if causal else S * T
    ops_ms = 7 * 2 * B * H * D * pairs / smoke.BF16_OPS_PER_S * 1e3
    part_ms = 2 * 2 * B * T * (H // hg) * D * 4 / smoke.HBM_BYTES_PER_S * 1e3
    return ops_ms + part_ms, ops_ms, part_ms


_EARLIER, _EARLIER_LOCK = {}, threading.Lock()


def earlier_entry():
    """The earlier design, built once with the package's nvcc flags: its C
    entry point.  Safe to call from several threads (chip_smoke.py starts
    the build in a thread beside the package's own)."""
    from repro_torch.kernels import _build

    with _EARLIER_LOCK:
        if "fn" not in _EARLIER:
            out_dir = _build.BUILD_DIR / "earlier"
            out_dir.mkdir(parents=True, exist_ok=True)
            src = out_dir / "flash_prefill_bwd_earlier.cu"
            src.write_text(EARLIER)
            lib = out_dir / "libflash_prefill_bwd_earlier.so"
            proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {lib.name}:\n{proc.stdout}{proc.stderr}")
            fn = ctypes.CDLL(str(lib)).repro_flash_prefill_bwd_earlier
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p] * 10 + [i] * 6 + [ctypes.c_float, i, p]
            fn.restype = ctypes.c_int
            _EARLIER["fn"] = fn
        return _EARLIER["fn"]


def earlier_bwd(q, k, v, out, do, lse, causal):
    """(dq, dk, dv) of the earlier mma.sync design (bf16, D in {64, 96, 128})."""
    import torch

    from repro_torch.kernels import _build

    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.check(earlier_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                                 dk.data_ptr(), dv.data_ptr(), B, S, T, H, Hkv, D,
                                 1.0 / math.sqrt(D), int(causal), _build.stream_of(q)),
                 "flash_prefill_bwd (earlier mma.sync design)")
    return dq, dk, dv


def time_in_turns(torch, new, old, flush, reps=REPS):
    """``new()`` (the wgmma design) and ``old()`` (the earlier one) cold, in
    the order new, old, old, new: (new ms, old ms, the four times)."""
    turns = [smoke.timed_ms(torch, fn, reps, flush) for fn in (new, old, old, new)]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, dict(zip(("new", "old", "old2",
                                                                          "new2"), turns))


def floor_ms(torch, dev, flush):
    """The floor of the timing: the wgmma design at B = S = T = H = Hkv = 1,
    D = 128, causal, its three launches one block each."""
    from repro_torch.kernels.flash_prefill.ops import flash_prefill_bwd, flash_prefill_lse

    q, k, v, do = (torch.randn(1, 1, 1, 128, device=dev).to(torch.bfloat16) for _ in range(4))
    out, lse = flash_prefill_lse(q, k, v, True)
    return smoke.timed_ms(torch, lambda: flash_prefill_bwd(q, k, v, out, do, lse, True), 20, flush)


def parts(torch, q, k, v, out, do, lse, causal):
    """Device time of each launch of one wgmma backward call, from
    torch.profiler: kernel name -> (ms, count)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_prefill.kernel import WGMMA, grid_prefill_bwd

    grid_prefill_bwd(q, k, v, out, do, lse, causal, which=WGMMA)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        grid_prefill_bwd(q, k, v, out, do, lse, causal, which=WGMMA)
        torch.cuda.synchronize()
    out_ = {}
    for e in prof.key_averages():
        for name in ("dq_kernel", "dkv_kernel", "dkv_sum_kernel"):
            if name in e.key and e.self_device_time_total > 0:
                out_[name] = (e.self_device_time_total / 1e3, e.count)
    return out_


def time_designs(torch, dev, flush):
    """Phase 28 (a) at every bf16 case of BWD_CASES, with both bounds, the
    floor and glm4-9b's launches by kernel."""
    from repro_torch.kernels.flash_prefill.kernel import WGMMA, bwd_design, bwd_heads_per_block
    from repro_torch.kernels.flash_prefill.ops import flash_prefill_lse

    rows = []
    for label, shape, bf16, causal in smoke.BWD_CASES:
        if not bf16:
            continue
        row = smoke.check_bwd_case(torch, dev, label, shape, bf16, causal, flush)
        rows.append(row)
        torch.cuda.empty_cache()
    floor = floor_ms(torch, dev, flush)
    B, S, T, H, Hkv, D = GLM4[1]
    gen = torch.Generator(device=dev).manual_seed(S * 7 + D)
    q, do = (torch.randn(B, S, H, D, generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    out, lse = flash_prefill_lse(q, k, v, True)
    launches = parts(torch, q, k, v, out, do, lse, True)
    print(f"flash_prefill_bwd designs, cold (L2 flushed), in turns (new, old, old, new); "
          f"earlier design: {EARLIER_DESIGN}; floor of the timing {floor * 1e3:.1f} us")
    for r in rows:
        s = r["shape"]
        hg = bwd_heads_per_block(s["H"], s["Hkv"])
        own = own_bound(s["B"], s["S"], s["T"], s["H"], s["Hkv"], s["D"], r["causal"], hg)
        r["own_bound_ms"] = own[0] if r["design"] == WGMMA else None
        earlier = (f"earlier {r['earlier_ms'] * 1e3:.1f} us, new / old "
                   f"{r['ms'] / r['earlier_ms']:.3f}" if r.get("earlier_ms") else "no earlier")
        print(f"  {r['label']:18s} [{r['design']}]: {r['ms'] * 1e3:9.1f} us; {earlier}; bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['ms'] / r['bound_ms']:.2f}x)"
              + (f", own bound {own[0] * 1e3:.1f} us ({own[1] * 1e3:.1f} products + "
                 f"{own[2] * 1e3:.1f} partials, hg {hg})" if r["design"] == WGMMA else "")
              + f"; plain {r['plain_ms'] * 1e3:.1f} us; SDPA backward "
              f"{r['library_ms'] * 1e3:.1f} us ({r['ms'] / r['library_ms']:.2f}x)")
    print(f"  glm4-9b train, one wgmma call's launches (torch.profiler): "
          + ", ".join(f"{n} {ms * 1e3:.1f} us ({c}x)" for n, (ms, c) in launches.items()))
    assert bwd_design(torch.bfloat16, D) == WGMMA
    return {"cases": rows, "floor_ms": floor, "glm4_launches": launches,
            "earlier_design": EARLIER_DESIGN}


def ptxas_registers(log: str) -> dict:
    """Kernel -> (registers, spill store bytes, serialized) of each instance
    in a ``-Xptxas -v`` log: ("dq", D, keys, stages), ("dkv", D, stages) or
    ("sum",)."""
    out, key, serialized = {}, None, set()
    for line in log.splitlines():
        if "C7512" in line or "C7514" in line or "C7518" in line or "C7515" in line:
            m = re.search(r"(dq|dkv)_kernelILi(\d+)ELi(\d+)E(?:Li(\d+)E)?", line)
            if m:
                serialized.add((m.group(1), *(int(x) for x in m.groups()[1:] if x)))
            continue
        if "Compiling entry" in line:
            m = re.search(r"(dq|dkv)_kernelILi(\d+)ELi(\d+)E(?:Li(\d+)E)?", line)
            key = ((m.group(1), *(int(x) for x in m.groups()[1:] if x)) if m else
                   ("sum",) if "dkv_sum_kernel" in line else None)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if key and spill:
            out[key] = [None, int(spill.group(1))]
        used = re.search(r"Used (\d+) registers", line)
        if key and used:
            out.setdefault(key, [None, 0])[0] = int(used.group(1))
            key = None
    return {k: (v[0], v[1], k in serialized) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def sweep_entry():
    """``csrc/flash_prefill_bwd_wgmma.cu`` built with every plan of SWEEP:
    its entry point and ptxas's figures by kernel."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_prefill.kernel import _bind_bwd_wgmma

    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    plans = " ".join(f"X({', '.join(map(str, plan))})" for plan in SWEEP)
    src = out_dir / "flash_prefill_bwd_wgmma_sweep.cu"
    src.write_text(f"#define BWD_WG_PLANS {plans}\n"
                   f"#include \"{_build.sources()['flash_prefill_bwd_wgmma'].resolve()}\"\n")
    lib = out_dir / "libflash_prefill_bwd_wgmma_sweep.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {lib.name}:\n{proc.stdout}{proc.stderr}")
    return (_bind_bwd_wgmma(ctypes.CDLL(str(lib)).repro_flash_prefill_bwd_wgmma),
            ptxas_registers(proc.stdout + proc.stderr))


def _inputs(torch, dev, B, S, T, H, Hkv, D, causal, seed):
    from repro_torch.kernels.flash_prefill.ops import flash_prefill_lse

    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(B, S, H, D, generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    out, lse = flash_prefill_lse(q, k, v, causal)
    return q, k, v, out, do, lse


def _run(torch, fn, x, causal, plan, hg):
    from repro_torch.kernels.flash_prefill.kernel import launch_bwd_wgmma

    q, k, v, out, do, lse = x
    B, S, H, _ = q.shape
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch_bwd_wgmma(fn, q, k, v, out, do, lse, delta, dq, dk, dv, causal, plan=plan, hg=hg)
    return dq, dk, dv


def sweep(torch, dev, flush):
    """Every plan of SWEEP at every head group of HEAD_GROUPS: held against
    the plain version at SWEEP_CHECKS (8 bf16 ulps of each output's
    largest, bit for bit on repeat), timed cold at glm4-9b's training
    microbatch; printed fastest first."""
    from repro_torch.kernels.flash_prefill.kernel import (
        BWD_DKV_STAGES,
        BWD_DQ_KEYS,
        BWD_DQ_STAGES,
        BWD_HEAD_GROUP,
        bwd_heads_per_block,
        bwd_plan,
    )
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_bwd_ref

    fn, regs = sweep_entry()
    checks = []
    for i, (B, S, T, H, Hkv, D, causal) in enumerate(SWEEP_CHECKS):
        x = _inputs(torch, dev, B, S, T, H, Hkv, D, causal, seed=60 + i)
        checks.append((x, causal, flash_prefill_bwd_ref(*x, causal)))
    B, S, T, H, Hkv, D = GLM4[1]
    big = _inputs(torch, dev, B, S, T, H, Hkv, D, True, seed=70)
    chosen = (BWD_DQ_KEYS, BWD_DQ_STAGES, BWD_DKV_STAGES)
    rows = []
    for plan in SWEEP:
        for hg in HEAD_GROUPS:
            p = bwd_plan(D, *plan)
            worst = 0.0
            for x, causal, want in checks:
                h = bwd_heads_per_block(x[0].shape[2], x[1].shape[2], hg)
                pd = bwd_plan(x[0].shape[3], *plan)
                got = _run(torch, fn, x, causal, pd, h)
                again = _run(torch, fn, x, causal, pd, h)
                smoke.need(all(torch.equal(a, b) for a, b in zip(got, again)),
                           f"flash_prefill_bwd plan {plan} hg {h} does not repeat")
                for a, w in zip(got, want):
                    err = float((a.float() - w.float()).abs().max())
                    lim = smoke.BWD_ULPS * smoke.bf16_ulp(float(w.float().abs().max()))
                    smoke.need(err <= lim, f"plan {plan} hg {h}: {err} over {lim}")
                    worst = max(worst, err / lim)
            ms = smoke.timed_ms(torch, functools.partial(_run, torch, fn, big, True, p, hg), REPS,
                                flush)
            rows.append({"dq_keys": plan[0], "dq_stages": plan[1], "dkv_stages": plan[2],
                         "heads_per_block": hg, "ms": ms,
                         "worst_err_over_limit": worst,
                         "dq_ptxas": regs.get(("dq", D, plan[0], plan[1])),
                         "dkv_ptxas": regs.get(("dkv", D, plan[2])),
                         "chosen": plan == chosen and hg == BWD_HEAD_GROUP})
    print(f"flash_prefill_bwd wgmma plans at glm4-9b's training microbatch {GLM4[1]}, cold, "
          f"fastest first ((registers, spill bytes, wgmma serialized) from ptxas):")
    for r in sorted(rows, key=lambda r: r["ms"]):
        print(f"  dQ keys {r['dq_keys']:3d} stages {r['dq_stages']} {r['dq_ptxas']}; dK/dV "
              f"stages {r['dkv_stages']} {r['dkv_ptxas']}; hg "
              f"{r['heads_per_block']:2d}: {r['ms'] * 1e3:8.1f} us"
              f"{'  <- the plan' if r['chosen'] else ''}")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: time_flash_bwd_designs.py needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    print(smoke.nvidia_smi_line())
    _build.build_all()
    earlier_entry()
    dev = torch.device("cuda", torch.cuda.current_device())
    flush = smoke.l2_flush(torch, dev)
    if "--sweep" in sys.argv[1:]:
        out = {"sweep": sweep(torch, dev, flush)}
    else:
        out = time_designs(torch, dev, flush)
    print(smoke.nvidia_smi_line())
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except smoke.Failed as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
