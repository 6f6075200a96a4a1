"""Shared model pieces: dtypes, RMSNorm, RoPE, the token shift, the initialisers and the loss.

Counterpart of ``repro.models.common``.  Each function rounds where the
JAX version rounds: ``rmsnorm`` normalises in float32, rounds to the input
type and multiplies by the weight in that type; ``apply_rope`` rotates in
float32 and rounds once.  The initialisers draw from an explicit
``torch.Generator`` at the scales of ``dense_init`` (1/sqrt(in)) and
``embed_init`` (0.02), in float32, and round once to the requested type.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return x.mul_(scale).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype: torch.dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """(in_dim, out_dim) normal weights, the JAX layout: ``x @ w``."""
    s = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return _normal(gen, (in_dim, out_dim), s, dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype: torch.dtype) -> torch.Tensor:
    return _normal(gen, (vocab, dim), 0.02, dtype)


def rmsnorm_init(dim: int, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.ones(dim, dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (..., S, H, D) by (..., S) positions; the halves convention."""
    if theta <= 0:
        return x
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def softmax_cross_entropy(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) integer
    mask: Optional[torch.Tensor] = None,  # (B, S), 1 = count
    z_loss: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token loss in float32, plus ``z_loss`` times the squared
    log-sum-exp (logit drift control), over the positions ``mask`` counts;
    and the mean log-sum-exp over the same positions."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss > 0:
        nll = nll + z_loss * torch.square(lse)
    if mask is None:
        return nll.mean(), lse.mean()
    denom = torch.clamp_min(mask.sum(), 1.0)
    return (nll * mask).sum() / denom, (lse * mask).sum() / denom


def shift_tokens(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1} with zero at t=0 (RWKV's token shift), along axis 1 of (B, S, D)."""
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1, :]
