"""RWKV-6 ("Finch"): attention-free token mixing with a data-dependent decay.

Counterpart of ``repro.models.rwkv``.  Per head (head dim n) the state S
is n x n; for each step t

    a_t = k_t (outer) v_t
    y_t = r_t @ (S_{t-1} + diag(u) a_t)
    S_t = diag(w_t) S_{t-1} + a_t

with the per-channel decay w_t = exp(-exp(w0 + lora(x_t))).  The
recurrence runs in one launch of the hand-written ``wkv6`` kernel a layer
(:mod:`repro_torch.kernels.wkv6`), for a whole prompt and for one decode
token alike; every matrix product is ``@``.  Each function rounds where the
reference rounds: the token-shift lerps ``x*mu + x_prev*(1-mu)`` run in the
compute type, r, k and v are cast to float32 after their products, the
decay is float32 (``w0`` and ``u`` are float32 leaves under any compute
type), y is rounded to x's type before ``rmsnorm(y, ln_x) * g``.  The
channel mix is squared ReLU with a sigmoid gate.

A ``state`` passed to :func:`rwkv_time_mix` (and so to
:func:`rwkv_block_fwd`) is read and its S tensor written in place by the
kernel: the model's prefill and decode pass views of the cache, so no step
copies it.  Training (``state`` None, under autograd) runs the recurrence
through ``kernels.wkv6.ops.WKV6`` with the same roundings: the kernel
forward from a zero state, the ``wkv6_bwd`` kernel backward, the final
state a new tensor that no loss reads.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6.ops import wkv6

from .common import _normal, dense_init, rmsnorm, rmsnorm_init, shift_tokens

LORA_RANK = 64

Params = Dict[str, torch.Tensor]


def init_rwkv_block(gen: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    """One block's weights at ``repro``'s scales, in ``dtype``; ``w0``
    (N(0, 0.1) - 6) and ``u`` (N(0, 0.1), (heads, head dim)) in float32."""
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    dev = gen.device

    def half():
        return torch.full((d,), 0.5, dtype=dtype, device=dev)

    return {
        "ln1": rmsnorm_init(d, dtype, dev),
        "ln2": rmsnorm_init(d, dtype, dev),
        # time mix
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(), "mu_g": half(),
        "w_r": dense_init(gen, d, d, dtype),
        "w_k": dense_init(gen, d, d, dtype),
        "w_v": dense_init(gen, d, d, dtype),
        "w_g": dense_init(gen, d, d, dtype),
        "w_o": dense_init(gen, d, d, dtype),
        "w0": _normal(gen, (d,), 0.1, torch.float32) - 6.0,
        "w_lora_a": dense_init(gen, d, LORA_RANK, dtype),
        "w_lora_b": dense_init(gen, LORA_RANK, d, dtype, scale=0.01),
        "u": _normal(gen, (d // hd, hd), 0.1, torch.float32),
        "ln_x": rmsnorm_init(d, dtype, dev),
        # channel mix
        "mu_ck": half(), "mu_cr": half(),
        "w_ck": dense_init(gen, d, cfg.d_ff, dtype),
        "w_cv": dense_init(gen, cfg.d_ff, d, dtype),
        "w_cr": dense_init(gen, d, d, dtype),
    }


def block_params(cfg) -> int:
    """The parameters :func:`init_rwkv_block` draws: six d x d matrices, the
    channel mix's two d x d_ff, the decay's LoRA, and twelve d-vectors (three
    norms, seven lerp weights, ``w0`` and ``u``)."""
    d = cfg.d_model
    return 6 * d * d + 2 * d * cfg.d_ff + 2 * LORA_RANK * d + 12 * d


def _decay(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """The data-dependent decay w_t in (0, 1): exp(-exp(w0 + lora(x))), float32."""
    lora = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    return torch.exp(-torch.exp(p["w0"] + lora.float()))


def _previous(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1}: the token shift, from ``last`` (B, D) at t = 0 or from zero."""
    if last is None:
        return shift_tokens(x)
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg,
                  state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x: (B, S, D).  ``state`` = (last x (B, D), S (B, H, n, n) float32),
    whose S the kernel updates in place, or None (a zero state).  Returns
    the output and (x's last row, the final S)."""
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    if state is None:
        x_prev = _previous(x, None)
        s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    else:
        x_prev = _previous(x, state[0])
        s0 = state[1]

    def lerp(mu):
        return x * mu + x_prev * (1 - mu)

    r = (lerp(p["mu_r"]) @ p["w_r"]).reshape(B, S, H, hd).float()
    k = (lerp(p["mu_k"]) @ p["w_k"]).reshape(B, S, H, hd).float()
    v = (lerp(p["mu_v"]) @ p["w_v"]).reshape(B, S, H, hd).float()
    g = F.silu(lerp(p["mu_g"]) @ p["w_g"])
    w = _decay(p, lerp(p["mu_w"])).reshape(B, S, H, hd)

    y, s_final = wkv6(r, k, v, w, p["u"], s0)
    y = rmsnorm(y.reshape(B, S, D).to(x.dtype), p["ln_x"]) * g
    return y @ p["w_o"], (x[:, -1, :], s_final)


def rwkv_channel_mix(p: Params, x: torch.Tensor, state: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared-ReLU channel mixing with a sigmoid gate and the token shift
    (``state``: the last x (B, D), or None for zero); the output and x's
    last row."""
    x_prev = _previous(x, state)
    xk = x * p["mu_ck"] + x_prev * (1 - p["mu_ck"])
    xr = x * p["mu_cr"] + x_prev * (1 - p["mu_cr"])
    k = torch.square(torch.relu(xk @ p["w_ck"]))
    return torch.sigmoid(xr @ p["w_cr"]) * (k @ p["w_cv"]), x[:, -1, :]


def rwkv_block_fwd(p: Params, x: torch.Tensor, cfg, state=None):
    """One block: pre-norm time mix, then pre-norm channel mix.  ``state`` =
    (tm_x, tm_s, cm_x) or None (a zero state); returns x and the new
    (tm_x, tm_s, cm_x), tm_s being the given tensor, updated in place."""
    tm_state = None if state is None else (state[0], state[1])
    h, (tm_x, tm_s) = rwkv_time_mix(p, rmsnorm(x, p["ln1"]), cfg, state=tm_state)
    x = x + h
    h, cm_x = rwkv_channel_mix(p, rmsnorm(x, p["ln2"]), None if state is None else state[2])
    return x + h, (tm_x, tm_s, cm_x)
