"""Binding of ``csrc/flash_prefill.cu``.

Counterpart of ``repro.kernels.flash_prefill.kernel._grid_prefill``: one
launch over a grid of (query tile, query head, batch), each block looping
over the key tiles up to the diagonal.  A ragged S is handled in the
kernel; nothing is padded here.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

TILE = 64  # query rows and keys of a tile (kTile in the source)
MAX_HEAD_DIM = 256


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("flash_prefill").repro_flash_prefill
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, S, H, D) and k, v (B, S, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if H % k.shape[2]:
        raise ValueError("H must be a multiple of Hkv")


def grid_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns (B, S, H, D) in q's type."""
    B, S, H, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash prefill takes float32 or bfloat16, got {q.dtype}")
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} is outside the kernel's range")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.require(t, q.dtype, name, q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    _build.check(
        _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, k.shape[2], D,
            1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16), _build.stream_of(q),
        ),
        "flash_prefill",
    )
    return out
