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

:func:`flash_prefill_lse_ref` is training's forward: the same output and
each row's float32 log-sum-exp of its scaled scores, (B, H, S).
:func:`flash_prefill_bwd_ref` is the plain version of
``csrc/flash_prefill_bwd.cu``: dq, dk and dv by the textbook formulas in
float32 from q, k, v, the output o, its gradient dO and that log-sum-exp,
with delta_i = rowsum(dO * O); dk and dv sum the g query heads of a KV head.
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


def _scores(q, k, causal):
    """Scaled float32 scores (B, H, S, T), -1e30 above the diagonal where
    causal, and the (S, T) mask of those positions (None where not causal)."""
    S, D = q.shape[1], q.shape[3]
    T, g = k.shape[1], q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(D))
    future = None
    if causal:
        future = torch.ones(S, T, dtype=torch.bool, device=q.device).triu(1)
        s.masked_fill_(future, NEG_INF)
    return s, future


def flash_prefill_lse_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D); T == S where causal
    v: torch.Tensor,  # (B, T, Hkv, D)
    causal: bool = True,
):
    """(out (B, S, H, D) in q's type, lse (B, H, S) float32)."""
    g = q.shape[2] // k.shape[2]
    s, _ = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    w = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float().repeat_interleave(g, dim=2))
    return out.to(q.dtype), lse


def flash_prefill_bwd_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,  # (B, T, Hkv, D)
    o: torch.Tensor,  # (B, S, H, D): the forward's output
    dout: torch.Tensor,  # (B, S, H, D): the output's gradient
    lse: torch.Tensor,  # (B, H, S) float32: the forward's log-sum-exp
    causal: bool = True,
):
    """(dq, dk, dv) in q's type: P = exp(S - lse), dV = P^T dO, dP = dO V^T,
    dS = P (dP - delta), dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D)."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D)
    s, future = _scores(q, k, causal)
    p = torch.exp(s - lse[..., None])
    if future is not None:
        p.masked_fill_(future, 0.0)
    del s
    do = dout.float()
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    delta = (do * o.float()).sum(dim=-1).transpose(1, 2)  # (B, H, S)
    ds = p.mul_(torch.einsum("bqhd,bkhd->bhqk", do, vf).sub_(delta[..., None]))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dk = dk.reshape(B, T, Hkv, g, D).sum(dim=3)
    dv = dv.reshape(B, T, Hkv, g, D).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
