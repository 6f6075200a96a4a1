"""GQA/MQA attention of the dense serving path: causal prefill and decode.

Counterpart of ``repro.models.attention``, for the path a model server
runs.  Prefill attention over a whole prompt goes to
``kernels.flash_prefill`` and one-token decode over the KV cache to
``kernels.decode_attention``: on the card these are the hand-written CUDA
kernels, on the CPU their plain versions.  Weights are in the JAX layout
``(in, out)``.  The cross-attention, non-causal and ``q_offset`` branches
of ``repro``'s ``flash_attention``, and an int8 KV cache, are not ported.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_prefill.ops import flash_prefill

from .common import apply_rope, dense_init, rmsnorm, rmsnorm_init


def init_attention(gen: torch.Generator, cfg, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, h * hd, dtype),
        "wk": dense_init(gen, d, kv * hd, dtype),
        "wv": dense_init(gen, d, kv * hd, dtype),
        "wo": dense_init(gen, h * hd, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, gen.device)
        p["k_norm"] = rmsnorm_init(hd, dtype, gen.device)
    return p


def _project_qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    """(B, S, d_model) -> q (B, S, H, D), k and v (B, S, Hkv, D), roped."""
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, h, hd)
    k = (x @ p["wk"]).reshape(B, S, kv, hd)
    v = (x @ p["wv"]).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of a whole prompt on itself (S == T, no offset):
    the branch of ``repro``'s ``flash_attention`` that prefill takes."""
    return flash_prefill(q.contiguous(), k.contiguous(), v.contiguous())


def init_kv_cache(cfg, batch: int, max_len: int, dtype: torch.dtype,
                  device) -> Dict[str, torch.Tensor]:
    if cfg.kv_cache_dtype != "compute":
        raise NotImplementedError(f"kv_cache_dtype={cfg.kv_cache_dtype!r} is not ported")
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, 1, d_model)
    cache: Dict[str, torch.Tensor],  # {"k": (B, S, Hkv, D), "v": ...}, written in place
    position: int,  # index of the new token in every sequence
    cfg,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode over the KV cache: writes the new token's K and V at
    ``position`` in place (``repro`` returns an updated copy) and attends
    over positions 0 .. ``position``."""
    if "k_scale" in cache:
        raise NotImplementedError("an int8 KV cache is not ported")
    B = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ck, cv = cache["k"], cache["v"]
    if not 0 <= position < ck.shape[1]:
        raise ValueError(f"position {position} is outside a cache of {ck.shape[1]}")
    pos_b = torch.full((B, 1), position, dtype=torch.int64, device=x.device)
    q = (x @ p["wq"]).reshape(B, 1, h, hd)
    k = (x @ p["wk"]).reshape(B, 1, kvh, hd)
    v = (x @ p["wv"]).reshape(B, 1, kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, pos_b, cfg.rope_theta)
    k = apply_rope(k, pos_b, cfg.rope_theta)
    ck[:, position] = k[:, 0].to(ck.dtype)
    cv[:, position] = v[:, 0].to(cv.dtype)
    lengths = torch.full((B,), position + 1, dtype=torch.int32, device=x.device)
    out = decode_attention(q[:, 0].contiguous(), ck, cv, lengths)
    out = out.reshape(B, 1, h * hd).to(x.dtype)
    return out @ p["wo"], cache
