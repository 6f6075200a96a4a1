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
passes none and launches as before), and :func:`grid_prefill_bwd` binds the
gradient (dq, dk, dv) in two designs chosen by :func:`bwd_design`: bf16 at
D in {64, 96, 128} on wgmma and TMA (``csrc/flash_prefill_bwd_wgmma.cu``,
three launches: dQ, float32 partial dK and dV a group of query heads, their
sum), everything else, D = 192 and 256 included, on CUDA cores
(``csrc/flash_prefill_bwd.cu``, two launches; 32-key tiles past D = 128).

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
#: the backward kernel's designs (:func:`bwd_design`): bf16 at
#: BWD_WGMMA_HEAD_DIMS on wgmma and TMA (D = 96 as the forward lays it out,
#: three 64-byte-swizzled boxes a row), everything else on CUDA cores (D =
#: 192 and 256, gemma-7b's, in 32-key tiles); launches a call by design
#: (wgmma: dQ, the partial dK and dV, their sum; CUDA cores: dQ, then dK and
#: dV) and the largest head dimension, the forward's
BWD_WGMMA_HEAD_DIMS = (64, 96, 128)
BWD_LAUNCHES = {WGMMA: 3, CUDA_CORE: 2}
BWD_MAX_HEAD_DIM = MAX_HEAD_DIM
#: the wgmma backward's plan: query rows of a dQ block and keys of a dK/dV
#: block (two consumer warpgroups of 64), query rows of a dK/dV step, the
#: dQ block's key tile and ring stages, the dK/dV block's ring stages, and
#: at most this many query heads of a KV head a dK/dV block (the group
#: whose float32 partial dK and dV it writes); the library holds these
#: plans (BWD_WG_PLANS in the source), tools/time_flash_bwd_designs.py
#: --sweep builds more
BWD_ROWS, BWD_STEP_ROWS = 128, 64
BWD_DQ_KEYS, BWD_DQ_STAGES, BWD_DKV_STAGES = 64, 4, 2
BWD_HEAD_GROUP = 8


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
    if dtype == torch.bfloat16 and head_dim in BWD_WGMMA_HEAD_DIMS:
        return WGMMA
    return CUDA_CORE


def bwd_heads_per_block(n_heads: int, n_kv_heads: int, most: int = BWD_HEAD_GROUP) -> int:
    """Query heads a dK/dV block of the wgmma backward walks: the largest
    divisor of H / Hkv not above ``most``."""
    g = n_heads // n_kv_heads
    return max(d for d in range(1, min(g, most) + 1) if g % d == 0)


def bwd_plan(head_dim: int, dq_keys: int = BWD_DQ_KEYS, dq_stages: int = BWD_DQ_STAGES,
             dkv_stages: int = BWD_DKV_STAGES) -> dict:
    """The wgmma backward's tiles at ``head_dim`` and the shared memory of
    its first two launches (dq_smem and dkv_smem in the source, which checks
    them): the dQ block's Q and dO tiles (128 rows), its K/V ring, 128
    floats of delta and its mbarriers; the dK/dV block's K and V tiles (128
    keys), its ring of Q, dO and the 64 rows' lse and delta, and its
    mbarriers; 1024 bytes each to align the swizzled tiles."""
    D = head_dim
    dq = 1024 + 2 * BWD_ROWS * D * 2 + dq_stages * 2 * dq_keys * D * 2 + BWD_ROWS * 4 \
        + 8 * (1 + 2 * dq_stages)
    dkv = 1024 + 2 * BWD_ROWS * D * 2 + dkv_stages * (2 * BWD_STEP_ROWS * D * 2
                                                      + 2 * BWD_STEP_ROWS * 4) \
        + 8 * (1 + 2 * dkv_stages)
    return {"dq_rows": BWD_ROWS, "dq_keys": dq_keys, "dq_stages": dq_stages,
            "dkv_keys": BWD_ROWS, "dkv_rows": BWD_STEP_ROWS, "dkv_stages": dkv_stages,
            "dq_smem_bytes": dq, "dkv_smem_bytes": dkv}


def _bind_bwd_wgmma(fn):
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 12 + [i] * 6 + [ctypes.c_float] + [i] * 7 + [p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry_bwd_wgmma():
    return _bind_bwd_wgmma(_build.library("flash_prefill_bwd_wgmma").repro_flash_prefill_bwd_wgmma)


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
    """Launch the backward kernel on CUDA tensors: dq (B, S, H, D), dk and
    dv (B, T, Hkv, D) in q's type, from the forward's output ``o``, its
    gradient ``dout`` and the forward's ``lse`` (B, H, S) float32.  The dQ
    launch comes first and also writes each row's rowsum(dO * O) into a
    (B, H, S) float32 scratch; dK and dV follow over key tiles, every query
    head of a KV head and every query tile added in a fixed order
    (:data:`BWD_LAUNCHES` launches by design).  bf16 at D in
    ``BWD_WGMMA_HEAD_DIMS`` runs on wgmma and TMA, every other call on CUDA
    cores (:func:`bwd_design`; D = 192 and 256 in 32-key tiles), unless
    ``which`` names the design (the CUDA-core one takes every call).  No design gives way to another: an
    error raises."""
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
    if which not in BWD_LAUNCHES:
        raise ValueError(f"no backward design {which!r}; the designs are {sorted(BWD_LAUNCHES)}")
    if which == WGMMA and (q.dtype != torch.bfloat16 or D not in BWD_WGMMA_HEAD_DIMS):
        raise ValueError(f"the wgmma+tma backward does not take {q.dtype} at head_dim {D}")
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if which == WGMMA:
        launch_bwd_wgmma(_entry_bwd_wgmma(), q, k, v, o, dout, lse, delta, dq, dk, dv, causal)
        return dq, dk, dv
    _build.check(
        _entry_bwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), B, S, T, H, Hkv, D, 1.0 / math.sqrt(D), int(causal),
                     int(q.dtype == torch.bfloat16), _build.stream_of(q)),
        f"flash_prefill_bwd ({which})")
    return dq, dk, dv


def launch_bwd_wgmma(entry, q, k, v, o, dout, lse, delta, dq, dk, dv, causal, plan=None,
                     hg=None) -> None:
    """Run the wgmma backward's C entry point ``entry`` (the package's, or a
    build with other plans) into ``delta``, ``dq``, ``dk`` and ``dv``, with
    the float32 partials of dK and dV, (B, T, H / hg, D) each, as scratch:
    ``plan`` a :func:`bwd_plan`, ``hg`` the query heads of a dK/dV block
    (:func:`bwd_heads_per_block` by default)."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    plan = plan or bwd_plan(D)
    hg = hg or bwd_heads_per_block(H, Hkv)
    parts = torch.empty((2, B, T, H // hg, D), dtype=torch.float32, device=q.device)
    _build.check(
        entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              parts[0].data_ptr(), parts[1].data_ptr(), B, S, T, H, Hkv, D,
              1.0 / math.sqrt(D), int(causal), hg, plan["dq_keys"], plan["dq_stages"],
              plan["dkv_stages"], plan["dq_smem_bytes"], plan["dkv_smem_bytes"],
              _build.stream_of(q)),
        f"flash_prefill_bwd ({WGMMA})")
