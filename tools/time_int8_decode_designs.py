#!/usr/bin/env python3
"""The int8-cache decode kernel beside its PR 28 design, on one NVIDIA card.

    python3 tools/time_int8_decode_designs.py

Run from the root of a checkout.  ``csrc/decode_attention.cu``'s int8 mma
kernel (``decode_mma_q8_kernel``: each warp its own ring of codes and
scales, the fragments dequantized in registers, its own split plan) replaced
a design that staged the codes in a ring the block's warps shared and had
each warp convert its 16 rows into a bf16 tile in shared memory before its
products, split by the bf16 cache's rule.  That design is kept here as text
(``EARLIER``) and built into ``build/repro_torch/earlier/``.

:func:`time_designs` holds both against the plain version at one shape and
times them cold (L2 flushed), each at its own plan, in the order earlier,
current, current, earlier.  chip_smoke.py phase 25 (a) calls it at
mistral-nemo's served shape.  Alone it draws q and a quantized K and V at
that shape from a seed; it prints the card and its power limit first and a
JSON line last.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402

REPS = 20
#: what the earlier design did
EARLIER_DESIGN = ("PR 28: a 3-tile ring of codes and scales shared by the block's 4 warps (two "
                  "block barriers a tile), each warp's 16 rows converted into a bf16 warp tile "
                  "in shared memory and read back as fragments; the bf16 cache's split rule")
#: ``csrc/decode_attention.cu``'s int8 mma kernel as PR 28 had it
EARLIER = r"""// The int8 cache's mma kernel as csrc/decode_attention.cu had it in PR 28
// (kept as text by tools/time_int8_decode_designs.py): the 3-tile ring of
// codes and scales shared by the block's 4 warps (two block barriers a
// tile), each warp converting its own 16 rows of a tile into a bf16 warp
// tile in shared memory behind a warp barrier, then reading its fragments
// back (32-bit loads for K, ldmatrix.trans for V); the bf16 cache's split
// plan (mma_grid_plan before int8 had a rule of its own).  Only the int8
// instance at D <= 128 is built.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;    // cache positions staged in shared memory per step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync.m16n8k16 over a cp.async ring.

constexpr int kMmaThreads = 128;  // 4 warps, each 16 positions of a tile
constexpr int kMmaStages = 3;     // tiles of the ring
constexpr int kRowPad = 8;        // bf16 padding of a staged row (16 bytes)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kRowPad8 = 16;     // byte padding of a staged row of int8 codes

// Shared memory of one block at head dimension D: the ring of K and V tiles,
// which the warps' merge reuses (4 x 16 x D floats and 2 x 64 floats fit in
// it).  An int8 cache's ring holds codes (rows of D + 16 bytes) and a scale a
// row, and each warp a bf16 K and V tile of its 16 rows; the merge's
// 64 D + 128 floats fit in it too.  kernel.py's decode_plan computes the
// same figures and passes them in.
constexpr int mma_smem_bytes(int D) { return kMmaStages * 2 * kTile * (D + kRowPad) * 2; }
__host__ __device__ constexpr int mma_q8_ring_bytes(int D) {
  return kMmaStages * 2 * kTile * (D + kRowPad8);
}
__host__ __device__ constexpr int mma_q8_scale_bytes() { return kMmaStages * 2 * kTile * 4; }
__host__ __device__ constexpr int mma_q8_smem_bytes(int D) {
  return mma_q8_ring_bytes(D) + mma_q8_scale_bytes() + 4 * 2 * 16 * (D + kRowPad) * 2;
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

// 8 int8 codes at src (8-byte aligned) times scale, rounded to bf16, to dst
// (16-byte aligned): repro's dequantization of a bf16 model's cache.
__device__ __forceinline__ void dequant8_bf16(const int8_t* src, float scale,
                                              __nv_bfloat16* dst) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __halves2bfloat162(
        __float2bfloat16_rn(__fmul_rn((float)c[2 * e], scale)),
        __float2bfloat16_rn(__fmul_rn((float)c[2 * e + 1], scale)));
    o[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = out;
}

// NT: 16-column steps of D the registers are sized for (D <= 16 NT); the
// steps at or past D / 16 are skipped.  Writes partials as decode_split_kernel
// does (m in the natural-log domain), so decode_combine_kernel finishes both.
// C: the cache's type, bf16 or int8_t (then k_scale and v_scale, (B, S, Hkv)
// float32, dequantize it).
template <int NT, typename C>
__global__ void __launch_bounds__(kMmaThreads)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const C* __restrict__ k,
                  const C* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int* __restrict__ lengths, int H,
                  int Hkv, int D, long long S, int n_splits, long long split_len,
                  float scale_log2, float* __restrict__ part_m, float* __restrict__ part_l,
                  float* __restrict__ part_acc) {
  constexpr bool kQ8 = sizeof(C) == 1;
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
  // stage s: K [64][ld] then V [64][ld] (bf16); an int8 cache's stage s:
  // codes K [64][ld8] then V [64][ld8] in ring8, scales K [64] then V [64]
  // in scl, and each warp's bf16 K [16][ld] then V [16][ld] in wtile
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int ld8 = D + kRowPad8;
  int8_t* ring8 = reinterpret_cast<int8_t*>(smem_raw);
  float* scl = reinterpret_cast<float*>(smem_raw + mma_q8_ring_bytes(D));
  __nv_bfloat16* wtile = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + mma_q8_ring_bytes(D) + mma_q8_scale_bytes()) + warp * 2 * 16 * ld;

  auto load_tile = [&](int t) {
    const long long t0 = s_begin + (long long)kTile * t;
    const int valid = (int)min((long long)kTile, s_end - t0);
    const int stage = t % kMmaStages;
    if constexpr (sizeof(C) == 1) {  // an int8 cache: codes, and a scale a row
      int8_t* ks = ring8 + stage * 2 * kTile * ld8;
      int8_t* vs = ks + kTile * ld8;
      const int chunks = D / 16;  // 16-byte chunks of a row of codes
      for (int i = tid; i < kTile * chunks; i += kMmaThreads) {
        const int r = i / chunks, c = (i % chunks) * 16;
        const long long off = (((long long)b * S + t0 + min(r, valid - 1)) * Hkv + kvh) * D + c;
        const int bytes = r < valid ? 16 : 0;
        cp_async16(ks + r * ld8 + c, k + off, bytes);
        cp_async16(vs + r * ld8 + c, v + off, bytes);
      }
      float* kss = scl + stage * 2 * kTile;
      for (int r = tid; r < kTile; r += kMmaThreads) {
        const long long row = ((long long)b * S + t0 + min(r, valid - 1)) * Hkv + kvh;
        const int bytes = r < valid ? 4 : 0;
        cp_async4(kss + r, k_scale + row, bytes);
        cp_async4(kss + kTile + r, v_scale + row, bytes);
      }
    } else {
      __nv_bfloat16* ks = ring + stage * 2 * kTile * ld;
      __nv_bfloat16* vs = ks + kTile * ld;
      const int chunks = D / 8;  // 16-byte chunks of a row
      for (int i = tid; i < kTile * chunks; i += kMmaThreads) {
        const int r = i / chunks, c = (i % chunks) * 8;
        const long long off = (((long long)b * S + t0 + min(r, valid - 1)) * Hkv + kvh) * D + c;
        const int bytes = r < valid ? 16 : 0;
        cp_async16(ks + r * ld + c, k + off, bytes);
        cp_async16(vs + r * ld + c, v + off, bytes);
      }
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
      const __nv_bfloat16* ks;
      const __nv_bfloat16* vs;
      if constexpr (kQ8) {  // the warp's 16 rows of codes into its own bf16 tiles
        const int stage = t % kMmaStages;
        const int8_t* k8 = ring8 + stage * 2 * kTile * ld8 + 16 * warp * ld8;
        const float* ksc = scl + stage * 2 * kTile + 16 * warp;
        const int chunks = D / 8;
        for (int i = lane; i < 16 * chunks; i += 32) {
          const int r = i / chunks, c = (i % chunks) * 8;
          dequant8_bf16(k8 + r * ld8 + c, ksc[r], wtile + r * ld + c);
          dequant8_bf16(k8 + kTile * ld8 + r * ld8 + c, ksc[kTile + r], wtile + (16 + r) * ld + c);
        }
        __syncwarp();
        ks = wtile;
        vs = wtile + 16 * ld;
      } else {
        ks = ring + (t % kMmaStages) * 2 * kTile * ld + 16 * warp * ld;
        vs = ks + kTile * ld;
      }

      // scores of 16 rows x 16 keys: register 2r + e of n-block nb is row qr + 8r,
      // key key0 + 8 nb + qc + e
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
      uint32_t pa[4];  // P as the A fragment of O += P V
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
    __syncthreads();  // everyone is done with tile t's stage (and its warp tile): refill it
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
  const long long head0 = (long long)b * H + (long long)kvh * g + g0;
  for (int i = tid; i < rows * D; i += kMmaThreads) {
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

template <int NT, typename C>
int launch_mma(const void* q, const void* k, const void* v, const void* k_scale,
               const void* v_scale, const void* lengths, int B, int H, int Hkv, int D,
               long long S, int n_splits, long long split_len, float scale, int smem,
               void* part_m, void* part_l, void* part_acc, void* out, cudaStream_t stream) {
  const int need = sizeof(C) == 1 ? mma_q8_smem_bytes(D) : mma_smem_bytes(D);
  if (smem < need || smem < 4 * 16 * D * 4 + 2 * 64 * 4) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_mma_kernel<NT, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int row_tiles = (H / Hkv + 15) / 16;
  decode_mma_kernel<NT, C><<<dim3(n_splits, Hkv * row_tiles, B), kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const C*>(k), static_cast<const C*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(lengths), H, Hkv, D, S,
      n_splits, split_len, scale * kLog2e, static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<__nv_bfloat16><<<dim3(H, B), 128, 0, stream>>>(
      static_cast<const int*>(lengths), H, D, S, n_splits, split_len,
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q (B, H, D), int8 codes k and v (B, S, Hkv, D) with k_scale and v_scale
// (B, S, Hkv) float32; as repro_decode_attention_mma, 64 < D <= 128.
extern "C" int repro_decode_attention_mma_q8_earlier(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* lengths, int B, int H, int Hkv, int D, long long S, int n_splits,
    long long split_len, float scale, int smem_bytes, void* part_m, void* part_l, void* part_acc,
    void* out, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  if (D <= 64 || D % 16 || D > 128 || k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_mma<8, int8_t>(q, k, v, k_scale, v_scale, lengths, B, H, Hkv, D, S, n_splits,
                               split_len, scale, smem_bytes, part_m, part_l, part_acc, out,
                               static_cast<cudaStream_t>(stream));
}
"""


def earlier_smem(head_dim: int) -> int:
    """Shared memory of the earlier design's block: the shared ring of codes
    and scales, and each warp's bf16 K and V tiles of 16 rows."""
    return 3 * 2 * 64 * (head_dim + 16) + 3 * 2 * 64 * 4 + 4 * 2 * 16 * (head_dim + 8) * 2


def earlier_grid_plan(batch, heads, kv_heads, seq, head_dim, sm_count):
    """(n_splits, split_len) as the earlier design chose them: the bf16
    cache's rule (of the fewest whole tiles that fill the SMs' block slots
    in one wave and the fewest that put one block on an SM, the one with
    fewer tiles on the busiest SM), with the earlier block's slots."""
    units = batch * kv_heads * -(-(heads // kv_heads) // 16)
    n_tiles = -(-seq // 64)
    per_sm = max(1, 233_472 // (earlier_smem(head_dim) + 1024))

    def fewest_tiles(max_blocks):
        return -(-n_tiles // max(1, min(max_blocks // units, n_tiles)))

    def busiest(tiles):
        return -(-units * -(-n_tiles // tiles) // sm_count) * tiles

    tiles = fewest_tiles(per_sm * sm_count)
    alone = fewest_tiles(sm_count)
    if busiest(alone) < busiest(tiles):
        tiles = alone
    return -(-seq // (tiles * 64)), tiles * 64


@functools.lru_cache(maxsize=None)
def earlier_entry():
    """The earlier design, built with the package's nvcc flags: its C entry point."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "earlier"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "decode_q8_pr28.cu"
    src.write_text(EARLIER)
    lib = out_dir / "libdecode_q8_pr28.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {lib.name}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).repro_decode_attention_mma_q8_earlier
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, ctypes.c_longlong, i, ctypes.c_longlong,
                   ctypes.c_float, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def earlier_call(torch, q, k8, v8, ks, vs, lengths):
    """A callable that runs the earlier design (both passes) at its own plan
    into a fresh output, which it returns."""
    from repro_torch.kernels import _build

    B, H, D = q.shape
    S, Hkv = k8.shape[1], k8.shape[2]
    n_splits, split_len = earlier_grid_plan(B, H, Hkv, S, D, _build.sm_count(q.device.index))
    part_m = torch.empty((B, H, n_splits), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, H, n_splits, D), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    fn = earlier_entry()

    def call():
        _build.check(fn(q.data_ptr(), k8.data_ptr(), v8.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                        lengths.data_ptr(), B, H, Hkv, D, S, n_splits, split_len,
                        1.0 / math.sqrt(D), earlier_smem(D), part_m.data_ptr(), part_l.data_ptr(),
                        part_acc.data_ptr(), out.data_ptr(), _build.stream_of(q)),
                     "earlier int8 decode")
        return out

    return call, (n_splits, split_len)


def time_designs(torch, q, k8, v8, ks, vs, lengths, flush):
    """Both designs at one shape: each within one bf16 ulp of the largest
    output of the plain version, the current one bit for bit on repeat; cold
    in turns.  Returns the times, plans and errors."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    B, H, D = q.shape
    S, Hkv = k8.shape[1], k8.shape[2]
    want = decode_attention_ref(q, k8, v8, lengths, ks, vs).float()
    tol = 2.0 ** -7 * float(want.abs().max())
    old_call, old_plan = earlier_call(torch, q, k8, v8, ks, vs, lengths)

    def new_call():  # the wrapper's launch, uncounted
        return dk.grid_decode(q, k8, v8, lengths, ks, vs)

    got, old = new_call(), old_call()
    errs = {"current": float((got.float() - want).abs().max()),
            "earlier": float((old.float() - want).abs().max())}
    smoke.need(max(errs.values()) <= tol and torch.equal(got, new_call()),
               f"int8 decode designs against plain: {errs} (limit {tol}), or the current one "
               f"does not repeat")
    times = {"earlier": [], "current": []}
    for name in ("earlier", "current", "current", "earlier"):
        times[name].append(smoke.timed_ms(torch, old_call if name == "earlier" else new_call,
                                          REPS, flush))
    cur, ear = sum(times["current"]) / 2, sum(times["earlier"]) / 2
    plan = dk.mma_grid_plan(B, H, Hkv, S, D, _build.sm_count(q.device.index), int8=True)
    print(f"int8 decode B={B} H={H} Hkv={Hkv} D={D} S={S}, cold in turns (earlier, current, "
          f"current, earlier): current {times['current'][0] * 1e3:.2f} / "
          f"{times['current'][1] * 1e3:.2f} us at {plan[0]} splits of {plan[1] // 64} tiles, "
          f"earlier ({EARLIER_DESIGN}) {times['earlier'][0] * 1e3:.2f} / "
          f"{times['earlier'][1] * 1e3:.2f} us at {old_plan[0]} of {old_plan[1] // 64}; current "
          f"/ earlier {cur / ear:.3f}; max |kernel - plain| {errs}")
    return {"ms": cur, "earlier_ms": ear, "turns": times, "plan": list(plan),
            "earlier_plan": list(old_plan), "earlier_design": EARLIER_DESIGN,
            "max_abs_err": errs}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: time_int8_decode_designs.py needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models.attention import _quantize_kv

    print(smoke.nvidia_smi_line())
    _build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_arch(smoke.INT8_ARCH)
    B, S = smoke.SERVE_B, smoke.SERVE_S + smoke.SERVE_NEW
    gen = torch.Generator(device=dev).manual_seed(25)
    q = torch.randn(B, cfg.n_heads, cfg.head_dim, generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.randn(2, B, S, cfg.n_kv_heads, cfg.head_dim, generator=gen, device=dev)
    codes, scales = _quantize_kv(kv.to(torch.bfloat16))
    lengths = torch.arange(smoke.SERVE_S + 1, smoke.SERVE_S + 1 + B, device=dev,
                           dtype=torch.int32).clamp(max=S)
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)  # 256 MB > L2
    out = time_designs(torch, q, codes[0], codes[1], scales[0], scales[1], lengths, scratch.zero_)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except smoke.Failed as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
