"""Dense MLP blocks: SwiGLU, GeGLU and GELU (``repro.models.mlp``).

Weights are in the JAX layout ``(in, out)``; GELU is the tanh
approximation, as ``jax.nn.gelu`` is by default.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import dense_init


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    if activation in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, d_model, d_ff, dtype),
            "w_up": dense_init(gen, d_model, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d_model, dtype),
        }
    if activation == "gelu":
        return {
            "w_up": dense_init(gen, d_model, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d_model, dtype),
        }
    raise ValueError(f"unknown activation {activation}")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else _gelu
        return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return _gelu(x @ p["w_up"]) @ p["w_down"]
