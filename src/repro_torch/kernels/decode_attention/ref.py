"""Plain PyTorch version of GQA flash-decode attention.

Counterpart of ``repro.kernels.decode_attention.ref`` and of what the
Pallas ``decode_kernel`` computes: one query token per sequence attends over
the first ``lengths[b]`` positions of a padded KV cache, with K/V widened to
float32 and a float32 softmax.  The wrapper in :mod:`.ops` runs this on a
CPU tensor; on the card ``chip_smoke.py`` and the ``cuda`` tests hold
``csrc/decode_attention.cu`` against it.  Masked scores are the finite
-1e30 of the Pallas kernel; lengths lie in [1, S].

An int8 cache (int8 K/V codes and float32 scales of (B, S, Hkv)) is
dequantized first exactly as ``repro``'s ``attention_decode`` does it,
``float32(code) * scale`` rounded to q's type, and then attended as above.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,  # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) valid KV lengths
    k_scale: Optional[torch.Tensor] = None,  # (B, S, Hkv) float32, with int8 k and v
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if k_scale is not None:
        k = dequantize(k, k_scale, q.dtype)
        v = dequantize(v, v_scale, q.dtype)
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, H // Hkv, D)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k.float()) * scale
    mask = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def dequantize(codes: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, S, Hkv, D) int8 codes times their (B, S, Hkv) float32 scales, in
    float32, rounded to ``dtype``: ``repro``'s dequantization."""
    return (codes.float() * scale[..., None]).to(dtype)
