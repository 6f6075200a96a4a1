"""Mamba (selective SSM): the non-attention layer of Jamba.

Counterpart of ``repro.models.mamba``.  Per channel, with a state h of n
values,

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;   y_t = C_t . h_t + D x_t

with input-dependent dt, B and C and a causal depthwise convolution in
front.  The recurrence runs in one launch of the hand-written
``selective_scan`` kernel a layer (:mod:`repro_torch.kernels.selective_scan`),
for a whole prompt and for one decode token alike; the convolution is four
shifted products in the compute type, outside any kernel, as in the
reference.  Each function rounds where the reference rounds: the
projections run in the compute type, B, C and dt are cast to float32 after
their products, dt is softplus as ``jax.nn.softplus`` computes it
(``logaddexp(x, 0)``), ``A_log``, ``dt_bias`` and ``D`` are float32 leaves
under any compute type, and y is rounded to x's type before the gate.

A ``state`` passed to :func:`mamba_forward` is (the convolution's last
W - 1 inputs, h); the kernel writes the final h into the h tensor given, so
the model's prefill and decode pass views of the cache and no step copies
it.  The new convolution state is returned for the caller to store.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan.ops import selective_scan

from .common import _normal, dense_init

Params = Dict[str, torch.Tensor]


def init_mamba(gen: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    """One layer's weights at ``repro``'s scales, in ``dtype``: ``w_dt`` a
    full (d_in, d_in) product at scale 0.01, as the reference's (not
    Mamba's low-rank dt); ``dt_bias`` zeros, ``A_log`` log(1 .. n) in every
    row and ``D`` ones, in float32."""
    d, n = cfg.d_model, cfg.ssm_state_dim
    d_in = cfg.ssm_expand * d
    dev = gen.device
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev))
    return {
        "w_in": dense_init(gen, d, 2 * d_in, dtype),
        "conv_w": _normal(gen, (cfg.ssm_conv_width, d_in), 0.1, dtype),
        "w_bc": dense_init(gen, d_in, 2 * n, dtype),
        "w_dt": dense_init(gen, d_in, d_in, dtype, scale=0.01),
        "dt_bias": torch.zeros((d_in,), dtype=torch.float32, device=dev),
        "A_log": a_log.expand(d_in, n).contiguous(),
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, d_in, d, dtype),
    }


def mamba_params(cfg) -> int:
    """The parameters :func:`init_mamba` draws: the in, dt and out
    products, B and C's product, the convolution, ``dt_bias``, ``A_log``
    and ``D``."""
    d_in, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim
    return 3 * cfg.d_model * d_in + d_in * d_in + d_in * (3 * n + cfg.ssm_conv_width + 2)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution of x (B, S, C) by w (W, C), from the
    previous W - 1 inputs ``state`` (B, W - 1, C) or from zero.  Returns y
    and the new state, the last W - 1 rows of the padded input."""
    W, S = w.shape[0], x.shape[1]
    pad = x.new_zeros((x.shape[0], W - 1, x.shape[2])) if state is None else state
    xp = torch.cat([pad, x], dim=1)
    y = xp[:, 0:S, :] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S, :] * w[i]
    return y, xp[:, S:, :]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), smooth at every x (PyTorch's
    ``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def mamba_forward(p: Params, x: torch.Tensor, cfg,
                  state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x: (B, S, d_model).  ``state`` = (convolution state (B, W - 1, d_in),
    h (B, d_in, n) float32), whose h the kernel updates in place, or None (a
    zero state).  Returns the output and (the new convolution state, the
    final h)."""
    xin, z = (x @ p["w_in"]).chunk(2, dim=-1)
    xin, conv_state = causal_conv(xin, p["conv_w"], None if state is None else state[0])
    xin = F.silu(xin)
    Bm, Cm = (t.contiguous() for t in (xin @ p["w_bc"]).float().chunk(2, dim=-1))
    dt = softplus((xin @ p["w_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if state is None:
        h = torch.zeros((x.shape[0], xin.shape[-1], cfg.ssm_state_dim), dtype=torch.float32,
                        device=x.device)
    else:
        h = state[1]
    y = selective_scan(xin.float().contiguous(), dt, A, Bm, Cm, p["D"], h)
    out = (y.to(x.dtype) * F.silu(z)) @ p["w_out"]
    return out, (conv_state, h)

