"""GQA/MQA attention of the serving paths: prefill, encoder, cross-attention and decode.

Counterpart of ``repro.models.attention``, for the paths a model server
runs.  Attention over a whole sequence (``flash_attention``: a prompt's
causal self-attention, an encoder's non-causal self-attention, or
cross-attention over an encoder's rows) goes to ``kernels.flash_prefill``,
and one-token decode over the KV cache (and a decoded token's
cross-attention over all encoder rows) to ``kernels.decode_attention``: on
the card these are the hand-written CUDA kernels, on the CPU their plain
versions.  In training, whole-sequence attention is an autograd function
whose backward is the ``flash_prefill_bwd`` kernel (:class:`FlashAttention`);
the decode kernel has no backward and raises under autograd.  Weights are
in the JAX layout ``(in, out)``.  A KV cache is in
the compute type, or int8 with a float32 scale a (position, KV head)
(``kv_cache_dtype="int8"``), quantized as ``repro`` quantizes it.  The
``q_offset`` argument of ``repro``'s ``flash_attention`` is not ported:
nothing in ``repro`` passes it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_prefill.ops import (
    flash_prefill,
    flash_prefill_bwd,
    flash_prefill_lse,
)

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


def _project_q(p, x: torch.Tensor, cfg, positions: torch.Tensor) -> torch.Tensor:
    """(B, S, d_model) -> q (B, S, H, D), normed and roped as ``repro`` does."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    return apply_rope(q, positions, cfg.rope_theta)


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


class FlashAttention(torch.autograd.Function):
    """Training's attention: the forward is ``flash_prefill_lse`` (the
    prefill kernel, which also saves each row's log-sum-exp), the backward
    ``flash_prefill_bwd`` (the gradient kernel, from q, k, v, the output and
    that log-sum-exp).  On the CPU both are their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_prefill_lse(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_prefill_bwd(q, k, v, out, dout.contiguous(), lse, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    """q (B, S, H, D) over k, v (B, T, Hkv, D): causal (a prompt on itself,
    T == S) or not (an encoder, or cross-attention over T rows); ``repro``'s
    ``flash_attention`` without ``q_offset``.  Where autograd records it
    (grad mode on and an input that requires grad) it is
    :class:`FlashAttention`, whose backward is a kernel too; otherwise the
    serving call."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return flash_prefill(q, k, v, causal)


def attention_forward(p, x: torch.Tensor, cfg, positions: torch.Tensor, causal: bool = True,
                      kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Full-sequence attention (prefill, encoder, cross): (B, S, d_model) ->
    (B, S, d_model).  ``kv`` replaces the layer's own K and V with an
    encoder's, from :func:`project_cross_kv`."""
    B, S, _ = x.shape
    if kv is None:
        q, k, v = _project_qkv(p, x, cfg, positions)
    else:
        q, (k, v) = _project_q(p, x, cfg, positions), kv
    out = flash_attention(q, k, v, causal)
    return out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]


def project_cross_kv(p, enc: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder-output K/V for cross-attention (computed once an utterance)."""
    B, T, _ = enc.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    k = (enc @ p["wk"]).reshape(B, T, kvh, hd)
    v = (enc @ p["wv"]).reshape(B, T, kvh, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    return k, v


def cross_attention_decode(p, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
                           position: int) -> torch.Tensor:
    """A decoded token's cross-attention over all T encoder rows, (B, 1,
    d_model) -> (B, 1, d_model): ``repro``'s ``attention_forward(causal=False,
    kv=(k, v))`` at S = 1, which is one query over a cache of T positions, so
    it goes to the decode kernel with every length T."""
    B = x.shape[0]
    pos_b = torch.full((B, 1), position, dtype=torch.int64, device=x.device)
    q = _project_q(p, x, cfg, pos_b)
    lengths = torch.full((B,), k.shape[1], dtype=torch.int32, device=x.device)
    out = decode_attention(q[:, 0].contiguous(), k, v, lengths)
    return out.reshape(B, 1, cfg.n_heads * cfg.head_dim).to(x.dtype) @ p["wo"]


def init_kv_cache(cfg, batch: int, max_len: int, dtype: torch.dtype,
                  device) -> Dict[str, torch.Tensor]:
    """K and V of (B, max_len, Hkv, D) in ``dtype``, or for an int8 cache
    int8 codes and float32 ``k_scale``/``v_scale`` of (B, max_len, Hkv)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head symmetric int8 of x (B, S, Hkv, D): codes and
    float32 scales (B, S, Hkv), rounded half to even as ``jnp.round``."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def write_kv(cache: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
             start: int) -> None:
    """Write K and V (B, S, Hkv, D) at positions start .. start + S - 1 of a
    layer's cache in place: in its type, or quantized for an int8 cache."""
    end = start + k.shape[1]
    if "k_scale" in cache:
        for name, x in (("k", k), ("v", v)):
            codes, scale = _quantize_kv(x)
            cache[name][:, start:end] = codes
            cache[name + "_scale"][:, start:end] = scale
    else:
        cache["k"][:, start:end] = k.to(cache["k"].dtype)
        cache["v"][:, start:end] = v.to(cache["v"].dtype)


def attention_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, 1, d_model)
    cache: Dict[str, torch.Tensor],  # {"k": (B, S, Hkv, D), "v": ...[, scales]}, written in place
    position: int,  # index of the new token in every sequence
    cfg,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode over the KV cache: writes the new token's K and V at
    ``position`` in place (``repro`` returns an updated copy), quantized for
    an int8 cache, and attends over positions 0 .. ``position``."""
    B = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    if not 0 <= position < cache["k"].shape[1]:
        raise ValueError(f"position {position} is outside a cache of {cache['k'].shape[1]}")
    pos_b = torch.full((B, 1), position, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, pos_b)
    write_kv(cache, k, v, position)
    lengths = torch.full((B,), position + 1, dtype=torch.int32, device=x.device)
    out = decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"], lengths,
                           cache.get("k_scale"), cache.get("v_scale"))
    out = out.reshape(B, 1, h * hd).to(x.dtype)
    return out @ p["wo"], cache
