"""Binding of ``csrc/flash_prefill.cu`` and the choice of its two designs.

Counterpart of ``repro.kernels.flash_prefill.kernel._grid_prefill``: one
launch over a grid of (query tile, query head, batch), each block looping
over the key tiles up to the diagonal.  A ragged S is handled in the
kernel; nothing is padded here.  A non-causal call (``causal=False``) is
``repro``'s jnp ``flash_attention(causal=False)``, which the Pallas kernel
has no mode for: an encoder's self-attention (T == S) or cross-attention
of S query rows over T keys; each block then loops over every key tile up
to T, and only a ragged last tile masks.

Training adds two things: :func:`grid_prefill` takes an ``lse`` buffer,
which the same launch fills with each row's log-sum-exp (the serving call
passes none and launches as before), and :func:`grid_prefill_bwd` binds
``csrc/flash_prefill_bwd.cu``, the gradient (dq, dk, dv) in two launches,
in two designs chosen by :func:`bwd_design`: bf16 at D in {64, 96, 128} on
the tensor cores (``mma.sync``), everything else on CUDA cores.

:func:`design` names the design a call takes, by dtype and head dimension
alone: bf16 at D in {64, 96, 128, 192, 256} runs ``"wgmma+tma"`` (tensor
cores, TMA loads into a two-stage K/V ring; every bf16 call of the served
models, D = 64, 96 (phi-3-vision: three 64-byte-swizzled boxes a row), 128
and 256, is one), everything else ``"cuda-core"`` (the float32 CUDA-core
kernel: float32 inputs, which wgmma cannot multiply without TF32's loss,
and bf16 at another D, such as the smoke configurations' 16).  It is a
dispatch, not a fallback: an error of either design raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

TILE = 64  # query rows and keys of a tile of the CUDA-core design (kTile in the source)
MAX_HEAD_DIM = 256
#: head dimensions of the wgmma design: multiples of 64 (128-byte-swizzled
#: boxes of 64 columns) and 96 (three 64-byte-swizzled boxes of 32)
WGMMA_HEAD_DIMS = (64, 96, 128, 192, 256)
WGMMA = "wgmma+tma"
CUDA_CORE = "cuda-core"
#: the wgmma design's query rows a block (two consumer warpgroups of 64, and
#: a producer warpgroup) and K/V ring stages
WG_ROWS, WG_STAGES = 128, 2
#: training's forward in the wgmma design splits P into bf16 hi + lo for its
#: P V product: P rounded to bf16 alone, as serving rounds it, moved
#: glm4-9b's attention weights' gradients 1-4% (relative Frobenius) from the
#: plain version's on the card, past the 2e-2 chip_smoke.py's phase 28 holds
#: them to
SPLIT_P = "split P"
#: the backward kernel's designs (:func:`bwd_design`): bf16 at these head
#: dimensions on the tensor cores (``mma.sync``), everything else on CUDA
#: cores; launches a call (dQ, then dK and dV) and the largest head dimension
MMA = "mma.sync"
BWD_MMA_HEAD_DIMS = (64, 96, 128)
BWD_LAUNCHES = 2
BWD_MAX_HEAD_DIM = 128


def design(dtype: torch.dtype, head_dim: int) -> str:
    """The design a CUDA call with this dtype and head dimension launches."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return WGMMA
    return CUDA_CORE


def prefill_plan(head_dim: int) -> dict:
    """Tiles of the wgmma design at ``head_dim`` (any of
    ``WGMMA_HEAD_DIMS``: 128-key tiles up to D = 128, so D = 96 asks for
    124 032 bytes) and the shared memory a block asks for (wg::smem_bytes in
    the source, which checks it): the Q tile, the K and V ring, 128 bytes of
    mbarriers and 1024 of alignment."""
    key_tile = 128 if head_dim <= 128 else 64
    smem = 1024 + WG_ROWS * head_dim * 2 + 2 * WG_STAGES * key_tile * head_dim * 2 + 128
    return {"tile_rows": WG_ROWS, "key_tile": key_tile, "stages": WG_STAGES, "smem_bytes": smem}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("flash_prefill").repro_flash_prefill
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry_wgmma():
    fn = _build.library("flash_prefill").repro_flash_prefill_wgmma
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def bwd_design(dtype: torch.dtype, head_dim: int) -> str:
    """The design a CUDA backward call with this dtype and head dimension
    launches."""
    if dtype == torch.bfloat16 and head_dim in BWD_MMA_HEAD_DIMS:
        return MMA
    return CUDA_CORE


@functools.lru_cache(maxsize=None)
def _entry_bwd_mma():
    fn = _build.library("flash_prefill_bwd").repro_flash_prefill_bwd_mma
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry_bwd():
    fn = _build.library("flash_prefill_bwd").repro_flash_prefill_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def mode(q: torch.Tensor, k: torch.Tensor, causal: bool) -> str:
    """The mode a call runs in: ``"causal"`` (a prompt on itself),
    ``"non-causal"`` (every row over all keys, T == S: an encoder) or
    ``"cross"`` (non-causal over T != S keys)."""
    if causal:
        return "causal"
    return "non-causal" if k.shape[1] == q.shape[1] else "cross"


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, S, H, D) and k, v (B, T, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[1] < 1:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if causal and k.shape[1] != S:
        raise ValueError(f"causal attention needs as many keys as queries: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if H % k.shape[2]:
        raise ValueError("H must be a multiple of Hkv")


def train_design(dtype: torch.dtype, head_dim: int) -> str:
    """The design of training's forward: the wgmma design with P split
    where :func:`design` picks wgmma, else the CUDA-core design (whose P is
    float32 anyway)."""
    return f"{WGMMA}, {SPLIT_P}" if design(dtype, head_dim) == WGMMA else CUDA_CORE


def grid_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                 lse: Optional[torch.Tensor] = None, split_p: bool = False) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns (B, S, H, D) in q's type.

    bf16 at D in {64, 96, 128, 192, 256} launches the wgmma+TMA design,
    every other call the CUDA-core design (:func:`design`).  Where ``lse``
    (B, H, S) float32 is given, the same launch also writes each row's
    log-sum-exp of its scaled scores into it; ``split_p`` makes the wgmma
    design's P V product take P as bf16 hi + lo (training's forward)."""
    B, S, H, D = q.shape
    T = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash prefill takes float32 or bfloat16, got {q.dtype}")
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} is outside the kernel's range")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.require(t, q.dtype, name, q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if lse is not None:
        _build.require(lse, torch.float32, "lse", q.device)
        if lse.shape != (B, H, S):
            raise ValueError(f"lse must be (B, H, S) = {(B, H, S)}, got {tuple(lse.shape)}")
    lse_ptr = None if lse is None else lse.data_ptr()
    out = torch.empty_like(q)
    if design(q.dtype, D) == WGMMA:
        _build.check(
            _entry_wgmma()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, B, S, T, H,
                k.shape[2], D, 1.0 / math.sqrt(D), int(causal), prefill_plan(D)["smem_bytes"],
                int(split_p), _build.stream_of(q),
            ),
            "flash_prefill (wgmma+tma)",
        )
        return out
    _build.check(
        _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, B, S, T, H,
            k.shape[2], D, 1.0 / math.sqrt(D), int(causal), int(q.dtype == torch.bfloat16),
            _build.stream_of(q),
        ),
        "flash_prefill",
    )
    return out


def grid_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                     dout: torch.Tensor, lse: torch.Tensor, causal: bool = True,
                     which: Optional[str] = None):
    """Launch ``csrc/flash_prefill_bwd.cu`` on CUDA tensors: dq (B, S, H,
    D), dk and dv (B, T, Hkv, D) in q's type, from the forward's output
    ``o``, its gradient ``dout`` and the forward's ``lse`` (B, H, S)
    float32.  Two launches (:data:`BWD_LAUNCHES`): dQ over query tiles,
    which also writes each row's rowsum(dO * O) into a (B, H, S) float32
    scratch, then dK and dV over key tiles, every query head of a KV head
    and every query tile added in a fixed order.  bf16 at D in
    ``BWD_MMA_HEAD_DIMS`` runs on the tensor cores (``mma.sync``), every
    other call on CUDA cores (:func:`bwd_design`), unless ``which`` names
    the design (the CUDA-core one takes every call)."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash prefill's backward takes float32 or bfloat16, got {q.dtype}")
    if D % 8 or D > BWD_MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} is outside the backward kernel's range "
                         f"(a multiple of 8 up to {BWD_MAX_HEAD_DIM})")
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (dout, "dout")):
        _build.require(t, q.dtype, name, q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dout {tuple(dout.shape)} must be q's "
                         f"{tuple(q.shape)}")
    _build.require(lse, torch.float32, "lse", q.device)
    if lse.shape != (B, H, S):
        raise ValueError(f"lse must be (B, H, S) = {(B, H, S)}, got {tuple(lse.shape)}")
    which = which or bwd_design(q.dtype, D)
    if which == MMA and bwd_design(q.dtype, D) != MMA:
        raise ValueError(f"the mma.sync backward does not take {q.dtype} at head_dim {D}")
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S,
            T, H, Hkv, D, 1.0 / math.sqrt(D), int(causal))
    if which == MMA:
        code = _entry_bwd_mma()(*ptrs, _build.stream_of(q))
    else:
        code = _entry_bwd()(*ptrs, int(q.dtype == torch.bfloat16), _build.stream_of(q))
    _build.check(code, f"flash_prefill_bwd ({which})")
    return dq, dk, dv
