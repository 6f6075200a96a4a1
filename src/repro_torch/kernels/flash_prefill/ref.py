"""Plain PyTorch version of GQA prefill attention, causal or not.

Counterpart of ``repro.kernels.flash_prefill.ref`` and of what the Pallas
``prefill_kernel`` computes (causal: every prompt position attends over
itself and the positions before it), and of ``repro``'s jnp
``flash_attention`` with ``causal=False`` (every query row over all T keys:
an encoder's self-attention, T == S, or cross-attention over T encoder
rows).  Query head h reads KV head h // (H / Hkv), with Q/K/V widened to
float32 and a float32 softmax.  It builds the whole (B, H, S, T) score
matrix.  The wrapper in :mod:`.ops` runs this on a CPU
tensor; on the card ``chip_smoke.py`` and the ``cuda`` tests hold
``csrc/flash_prefill.cu`` against it.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_prefill_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D); T == S where causal
    v: torch.Tensor,  # (B, T, Hkv, D)
    causal: bool = True,
) -> torch.Tensor:
    B, S, H, D = q.shape
    T, g = k.shape[1], H // k.shape[2]
    scale = 1.0 / math.sqrt(D)
    kf = k.float().repeat_interleave(g, dim=2)  # KV head h // g for query head h
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if causal:
        future = torch.ones(S, T, dtype=torch.bool, device=q.device).triu(1)
        s.masked_fill_(future, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf).to(q.dtype)
