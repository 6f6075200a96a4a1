"""Mixture-of-experts layer: top-k routing, the dense mixture and capacity dispatch.

Counterpart of ``repro.models.moe`` off a mesh, where the reference's
batch-sharding degree is 1 and its ``shard`` constraints do nothing:

  1. router logits in float32 -> top-k (gates, expert ids) per token;
  2. where ``E * expert_ff <= 32 768`` (granite-moe) the dense mixture:
     every expert on every token, weighted by the top-k gates scattered
     into (T, E);
  3. else capacity dispatch (kimi-k2): the (T*K,) assignments sorted by
     expert (a stable sort, as ``jnp.argsort``: which token is dropped past
     capacity follows the order within an expert), ranked within their
     expert from the segment starts, ranks >= capacity dropped, the rest
     scattered into an (E, capacity, D) buffer, the per-expert SwiGLU, and
     the slots gathered back and combined with the gates.

The expert products are ``torch.einsum`` / ``torch.bmm``, as the reference's
are ``jnp.einsum`` outside any Pallas kernel.  The router's product runs in
float32 with TF32 off on the card, so top-k picks among the reference's
scores.  Everything stays on the device: no step reads a value back.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .common import _normal, dense_init

#: the largest E * expert_ff the reference evaluates as a dense mixture
DENSE_MIXTURE_MAX = 32_768


def init_moe(gen: torch.Generator, cfg, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The router (kept in float32, as the reference keeps it) and the
    (E, d, F), (E, d, F), (E, F, d) expert weights in ``dtype``, drawn an
    expert at a time: the float32 draw of one expert is the peak, not the
    whole (E, d, F) tensor's (22.5 GB at kimi-k2's width)."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_ff
    return {
        "router": dense_init(gen, d, e, torch.float32),
        "w_gate": _per_expert(gen, e, d, f, 1.0 / math.sqrt(d), dtype),
        "w_up": _per_expert(gen, e, d, f, 1.0 / math.sqrt(d), dtype),
        "w_down": _per_expert(gen, e, f, d, 1.0 / math.sqrt(f), dtype),
    }


def _per_expert(gen, e: int, rows: int, cols: int, scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    out = torch.empty((e, rows, cols), dtype=dtype, device=gen.device)
    for i in range(e):
        out[i] = _normal(gen, (rows, cols), scale, dtype)
    return out


class Routing(NamedTuple):
    """A layer's routing of T tokens: float32 logits and softmax (T, E), and
    the top-k gates (renormalised to sum 1) and expert ids (T, K)."""

    logits: torch.Tensor
    probs: torch.Tensor
    gates: torch.Tensor
    eidx: torch.Tensor


def _router_logits(xt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    x32 = xt.to(torch.float32)
    flag = torch.backends.cuda.matmul
    if not (x32.is_cuda and flag.allow_tf32):
        return x32 @ w
    flag.allow_tf32 = False
    try:
        return x32 @ w
    finally:
        flag.allow_tf32 = True


def route(p: Dict[str, torch.Tensor], xt: torch.Tensor, k: int) -> Routing:
    """Top-``k`` routing of tokens ``xt`` (T, D)."""
    logits = _router_logits(xt, p["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return Routing(logits, probs, gates, eidx)


def aux_losses(r: Routing) -> Dict[str, torch.Tensor]:
    """Switch-style load balance (E * sum of mean prob x routed fraction)
    and the router z-loss (mean squared logsumexp)."""
    E = r.probs.shape[1]
    me = r.probs.mean(dim=0)
    flat = r.eidx.reshape(-1)
    # routed assignments an expert, counted on the device (bincount reads its max back)
    ce = torch.zeros(E, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat)).to(torch.float32) / flat.numel()
    return {
        "load_balance_loss": E * torch.sum(me * ce),
        "router_z_loss": torch.mean(torch.square(torch.logsumexp(r.logits, dim=-1))),
    }


def capacity(tokens: int, cfg) -> int:
    """Slots an expert in the dispatch buffer (Python's round, as the
    reference's: half to even)."""
    return int(max(1, round(tokens * cfg.experts_per_token / cfg.n_experts
                            * cfg.capacity_factor)))


def dense_mixture(p: Dict[str, torch.Tensor], xt: torch.Tensor, r: Routing) -> torch.Tensor:
    """Every expert on every token, weighted by the gates: (T, D)."""
    gates_full = torch.zeros_like(r.probs).scatter_(1, r.eidx, r.gates)
    hd = F.silu(torch.einsum("td,edf->tef", xt, p["w_gate"])) * torch.einsum(
        "td,edf->tef", xt, p["w_up"])
    hd = hd * gates_full.to(xt.dtype)[:, :, None]
    return torch.einsum("tef,efd->td", hd, p["w_down"])


def dispatch(r: Routing, n_experts: int, cap: int) -> torch.Tensor:
    """Where each (token, k) assignment goes, in token order (T*K,): its row
    of an (E * cap + 1, D) buffer, expert e's slots at rows e * cap ..,
    the last row for an assignment dropped past capacity.  The assignments
    are sorted by expert (stable), ranked within their expert from the
    segment starts, and ranks >= ``cap`` dropped."""
    flat_e = r.eidx.reshape(-1)
    n = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, dtype=sorted_e.dtype, device=sorted_e.device))
    rank = torch.arange(n, device=sorted_e.device) - seg_start[sorted_e]
    spare = n_experts * cap
    sorted_slot = torch.where(rank < cap, sorted_e * cap + rank, spare)
    return torch.empty_like(sorted_slot).scatter_(0, order, sorted_slot)


def expert_swiglu(p: Dict[str, torch.Tensor], buf: torch.Tensor) -> torch.Tensor:
    """The per-expert SwiGLU of an (E, capacity, D) buffer."""
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    return torch.bmm(h, p["w_down"])


def capacity_dispatch(p: Dict[str, torch.Tensor], xt: torch.Tensor, r: Routing,
                      cap: int) -> torch.Tensor:
    """Scatter the kept assignments into (E, cap, D), run each expert on
    its slots, gather them back and combine with the gates: (T, D)."""
    T, D = xt.shape
    E, K = r.probs.shape[1], r.eidx.shape[1]
    slot = dispatch(r, E, cap)
    tok = torch.arange(T * K, device=xt.device) // K
    buf = xt.new_zeros((E * cap + 1, D))
    buf[slot] = xt[tok]  # every dropped assignment lands on the spare last row
    out = torch.cat([expert_swiglu(p, buf[:-1].view(E, cap, D)).reshape(E * cap, D),
                     xt.new_zeros((1, D))])
    comb = out[slot] * r.gates.reshape(-1).to(xt.dtype)[:, None]
    return comb.view(T, K, D).sum(dim=1)


def _forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> Tuple[torch.Tensor, Routing]:
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    r = route(p, xt, cfg.experts_per_token)
    if cfg.n_experts * cfg.expert_ff <= DENSE_MIXTURE_MAX:
        out = dense_mixture(p, xt, r)
    else:
        out = capacity_dispatch(p, xt, r, capacity(B * S, cfg))
    return out.reshape(B, S, D), r


def moe_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (B, S, D), aux {load_balance_loss, router_z_loss}."""
    out, r = _forward(p, x, cfg)
    return out, aux_losses(r)


def moe_output(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    """:func:`moe_forward`'s output alone, what prefill and decode use: the
    aux losses are training's, and the reference's serving path, compiled,
    drops them unused."""
    return _forward(p, x, cfg)[0]
