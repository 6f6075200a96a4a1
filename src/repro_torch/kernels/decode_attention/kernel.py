"""Binding of ``csrc/decode_attention.cu``, its two designs and its split of the cache.

Counterpart of ``repro.kernels.decode_attention.kernel._grid_decode``.  The
Pallas kernel walks the cache in order; here the cache is cut along S into
``n_splits`` runs of ``split_len`` positions (a multiple of the 64-position
tile), so that the split pass's blocks fill the card.  The split depends
only on the shapes and the card, so two calls agree bit for bit.

:func:`design` names the design a call takes, by dtype and head dimension
alone: bf16 at D % 16 == 0, D <= 256 runs ``"mma.sync+cp.async"`` (bf16
tiles on the tensor cores, a 3-tile cp.async ring; every bf16 call of the
served models, D = 128 and 256, is one), everything else ``"cuda-core"``
(float32 inputs, which the tensor cores cannot multiply without TF32's loss,
and bf16 at another D).  It is a dispatch, not a fallback: an error of
either design raises.

An int8 cache (int8 K/V codes with float32 scales of (B, S, Hkv), ``repro``'s
``kv_cache_dtype="int8"``) takes the same design by q's type and head
dimension, in a kernel of its own where it is the mma design: each warp
streams its own positions through its own ring of codes and scales and
dequantizes them in registers, into its fragments, as ``repro`` dequantizes
them (no dequantized copy anywhere); :func:`decode_plan` and
:func:`mma_grid_plan` give it a plan of its own (``int8=True``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

TILE = 64  # cache positions a block stages at once (kTile in the source)
THREADS = 256
MAX_GROUP_DIM = THREADS * 4 * 4  # (H / Hkv) * D a block accumulates (kMaxPacks float4 a thread)
MAX_HEAD_DIM = 256
BLOCKS_PER_SM = 2  # the CUDA-core split aims at this many blocks on every SM
MMA = "mma.sync+cp.async"
CUDA_CORE = "cuda-core"
MMA_STAGES, MMA_ROW_PAD = 3, 8  # ring tiles; bf16 padding of a staged row
MMA_ROW_PAD8 = 16  # byte padding of a staged row of int8 codes
#: the int8 mma kernel: 16-position slices in each warp's ring, and the
#: blocks an SM its registers are bounded for (kQ8Stages, kQ8Blocks in the
#: source; 2 fit past D = 128, where its launch bounds ask for 1)
MMA_Q8_STAGES, MMA_Q8_BLOCKS = 3, 3
SM_SHARED = 233_472  # shared memory of an H100 SM; each resident block reserves 1024 more


def design(dtype: torch.dtype, head_dim: int) -> str:
    """The design a CUDA call with this dtype and head dimension launches."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0 and head_dim <= MAX_HEAD_DIM:
        return MMA
    return CUDA_CORE


def decode_plan(head_dim: int, int8: bool = False) -> dict:
    """The mma design at ``head_dim``: its ring, the shared memory a block
    asks for (mma_smem_bytes, or mma_q8_smem_bytes for an int8 cache, in the
    source, which checks it) and how many blocks an SM holds.  An int8
    cache's block is 4 warps, each with a ring of ``MMA_Q8_STAGES`` slices
    of 16 rows of K and V codes and their 32 scales; its registers are
    bounded for ``MMA_Q8_BLOCKS`` blocks an SM up to D = 128 (2 past it), so
    an SM holds the fewer of that and what the shared memory allows."""
    if int8:
        slice_bytes = 2 * 16 * (head_dim + MMA_ROW_PAD8) + 2 * 16 * 4
        smem = 4 * MMA_Q8_STAGES * slice_bytes
        by_regs = MMA_Q8_BLOCKS if head_dim <= 128 else 2
        return {"tile": TILE, "stages": MMA_Q8_STAGES, "smem_bytes": smem,
                "blocks_per_sm": max(1, min(by_regs, SM_SHARED // (smem + 1024)))}
    smem = MMA_STAGES * 2 * TILE * (head_dim + MMA_ROW_PAD) * 2
    return {"tile": TILE, "stages": MMA_STAGES, "smem_bytes": smem,
            "blocks_per_sm": max(1, SM_SHARED // (smem + 1024))}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("decode_attention").repro_decode_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, ctypes.c_longlong, i, ctypes.c_longlong,
                   ctypes.c_float, p, p, p, p, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry_mma():
    fn = _build.library("decode_attention").repro_decode_attention_mma
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, ctypes.c_longlong, i, ctypes.c_longlong,
                   ctypes.c_float, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def split_plan(batch: int, kv_heads: int, seq: int, sm_count: int) -> Tuple[int, int]:
    """(n_splits, split_len) of the CUDA-core design: the fewest whole tiles
    a split such that the grid has at most ``BLOCKS_PER_SM * sm_count``
    blocks where it can (one wave, no second wave of a few blocks), with no
    empty split."""
    n_tiles = -(-seq // TILE)
    want = BLOCKS_PER_SM * sm_count // max(batch * kv_heads, 1)
    split_len = -(-n_tiles // max(1, min(want, n_tiles))) * TILE
    return -(-seq // split_len), split_len


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, H, D) and k, v (B, S, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if H % k.shape[2]:
        raise ValueError("H must be a multiple of Hkv")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if k_scale is None:
        if k.dtype == torch.int8:
            raise ValueError("an int8 cache needs k_scale and v_scale")
        return
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"scales go with an int8 cache, got {k.dtype} and {v.dtype}")
    for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
        if t.shape != k.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of {tuple(k.shape[:3])}, got {t.dtype} "
                             f"of {tuple(t.shape)}")


def mma_grid_plan(batch: int, heads: int, kv_heads: int, seq: int, head_dim: int,
                  sm_count: int, int8: bool = False) -> Tuple[int, int]:
    """(n_splits, split_len) of the mma design, a block a (split, KV head,
    16-query row tile, sequence).  Of two splits, the one that puts fewer
    tiles on the busiest SM (the first on a tie): the fewest whole tiles
    whose grid fills the SMs' block slots (as many blocks an SM as the ring
    allows) in one wave, and the fewest whose grid puts one block on an SM.
    At glm4-9b's B=8 on 132 SMs the second wins for the serving cache
    (S=2080: 7 splits of 5 tiles, where 11 of 3 put 6 tiles on 44 SMs) and
    the first at S=32 768 (16 splits of 32: two blocks an SM stream faster
    than one block of 64).

    An int8 cache (``int8=True``) takes the fewest whole tiles whose grid
    fits its block slots (``decode_plan(D, int8=True)["blocks_per_sm"]``, 3
    an SM up to D = 128) in one wave, and never the one-block-an-SM split.
    At mistral-nemo's served cache (B=8,
    Hkv=8, S=2080) that is 6 splits of 6 tiles, 384 blocks, where the rule
    above would take 2 of 17: chip_smoke.py phase 25's split sweep on an
    H100 finds the one-wave splits (6 to 9 tiles) fastest, splits past one
    wave (3 to 5 tiles) and 2 of 17 slower (PERF.md section 6, row 6)."""
    units = batch * kv_heads * -(-(heads // kv_heads) // 16)
    n_tiles = -(-seq // TILE)

    def fewest_tiles(max_blocks: int) -> int:
        return -(-n_tiles // max(1, min(max_blocks // units, n_tiles)))

    def busiest(tiles: int) -> int:
        return -(-units * -(-n_tiles // tiles) // sm_count) * tiles

    tiles = fewest_tiles(decode_plan(head_dim, int8)["blocks_per_sm"] * sm_count)
    if int8:
        return -(-seq // (tiles * TILE)), tiles * TILE
    alone = fewest_tiles(sm_count)
    if busiest(alone) < busiest(tiles):
        tiles = alone
    return -(-seq // (tiles * TILE)), tiles * TILE


def grid_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch both passes of the kernel on CUDA tensors; returns (B, H, D).

    bf16 at D % 16 == 0 launches the mma.sync design, every other call the
    CUDA-core design (:func:`design`); with scales, K and V are int8 codes."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode attention takes float32 or bfloat16, got {q.dtype}")
    mma = design(q.dtype, D) == MMA
    if D % 8 or D > MAX_HEAD_DIM or (not mma and (H // Hkv) * D > MAX_GROUP_DIM):
        raise ValueError(f"head_dim {D} with group {H // Hkv} is outside the kernel's range")
    int8 = k_scale is not None
    kv_dtype = torch.int8 if int8 else q.dtype
    for t, name, dtype in ((q, "q", q.dtype), (k, "k", kv_dtype), (v, "v", kv_dtype)):
        _build.require(t, dtype, name, q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    scales = (0, 0)
    if int8:
        for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            _build.require(t, torch.float32, name, q.device)
        scales = (k_scale.data_ptr(), v_scale.data_ptr())
    _build.require(lengths, torch.int32, "lengths", q.device)
    sms = _build.sm_count(q.device.index)
    if mma:
        n_splits, split_len = mma_grid_plan(B, H, Hkv, S, D, sms, int8)
    else:
        n_splits, split_len = split_plan(B, Hkv, S, sms)
    part_m = torch.empty((B, H, n_splits), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, H, n_splits, D), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    if mma:
        _build.check(
            _entry_mma()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales, lengths.data_ptr(), B, H, Hkv,
                D, S, n_splits, split_len, 1.0 / math.sqrt(D), decode_plan(D, int8)["smem_bytes"],
                part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                _build.stream_of(q),
            ),
            "decode_attention (mma.sync+cp.async)",
        )
        return out
    _build.check(
        _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales, lengths.data_ptr(), B, H, Hkv, D,
            S, n_splits, split_len, 1.0 / math.sqrt(D), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16),
            _build.stream_of(q),
        ),
        "decode_attention",
    )
    return out
