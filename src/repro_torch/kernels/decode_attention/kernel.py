"""Binding of ``csrc/decode_attention.cu`` and its split of the cache.

Counterpart of ``repro.kernels.decode_attention.kernel._grid_decode``.  The
Pallas kernel walks the cache in order; here the cache is cut along S into
``n_splits`` runs of ``split_len`` positions (a multiple of the 64-position
tile), so that (splits x KV heads x batch) blocks fill the card.  The split
depends only on the shapes and the card, so two calls agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build

TILE = 64  # cache positions a block stages at once (kTile in the source)
THREADS = 256
MAX_GROUP_DIM = THREADS * 4 * 4  # (H / Hkv) * D a block accumulates (kMaxPacks float4 a thread)
MAX_HEAD_DIM = 256
BLOCKS_PER_SM = 2  # the split aims at this many blocks on every SM


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("decode_attention").repro_decode_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_longlong, i, ctypes.c_longlong,
                   ctypes.c_float, p, p, p, p, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(batch: int, kv_heads: int, seq: int, sm_count: int) -> Tuple[int, int]:
    """(n_splits, split_len): the fewest whole tiles a split such that the
    grid has at most ``BLOCKS_PER_SM * sm_count`` blocks where it can (one
    wave, no second wave of a few blocks), with no empty split."""
    n_tiles = -(-seq // TILE)
    want = BLOCKS_PER_SM * sm_count // max(batch * kv_heads, 1)
    split_len = -(-n_tiles // max(1, min(want, n_tiles))) * TILE
    return -(-seq // split_len), split_len


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor) -> None:
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


def grid_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """Launch both passes of the kernel on CUDA tensors; returns (B, H, D)."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode attention takes float32 or bfloat16, got {q.dtype}")
    if D % 8 or D > MAX_HEAD_DIM or (H // Hkv) * D > MAX_GROUP_DIM:
        raise ValueError(f"head_dim {D} with group {H // Hkv} is outside the kernel's range")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.require(t, q.dtype, name, q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _build.require(lengths, torch.int32, "lengths", q.device)
    n_splits, split_len = split_plan(B, Hkv, S, _sm_count(q.device.index))
    part_m = torch.empty((B, H, n_splits), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, H, n_splits, D), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    _build.check(
        _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), B, H, Hkv, D, S,
            n_splits, split_len, 1.0 / math.sqrt(D), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16),
            _build.stream_of(q),
        ),
        "decode_attention",
    )
    return out
