"""AdamW with dtype-configurable moments, global-norm clipping, cosine schedule.

Counterpart of ``repro.train.optimizer``, written as the reference writes
it (not ``torch.optim.AdamW``, whose order of operations differs): clip
every gradient by ``min(1, clip_norm / global_norm)``, then for each leaf in
float32

    m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2,
    delta = (m / bc1) / (sqrt(v / bc2) + eps) + weight_decay p,
    p = p - lr delta,

the bias corrections ``bc = 1 - b^step`` and the decoupled weight decay
inside ``delta``; m and v are stored in ``moment_dtype`` (float32, or
bfloat16, which halves the optimizer's memory).  Unlike the reference,
which returns new arrays, :func:`apply_updates` writes the new weights and
moments into the given tensors in place (a leaf at a time, so the peak is
one leaf's temporaries, not a second copy of the model and its moments).

The step's scalars are computed on the host in float32 in the reference's
order of operations, so that ``lr_at`` is bit for bit ``repro``'s on the
CPU: the cosine and the bias corrections' power are the C math library's
single-precision ``cosf`` and ``powf``, which XLA's CPU backend matches.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from dataclasses import dataclass
from typing import Any, Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch

F32 = np.float32


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"  # "bfloat16" halves the optimizer's memory


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name, n in (("cosf", 1), ("powf", 2)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_float] * n
        fn.restype = ctypes.c_float
    return lib


def _cosf(x: np.float32) -> np.float32:
    return F32(_libm().cosf(float(x)))


def _powf(x: np.float32, y: np.float32) -> np.float32:
    return F32(_libm().powf(float(x), float(y)))


def lr_at(cfg: OptimizerConfig, step: int) -> float:
    """Linear warm-up to ``lr``, then a cosine down to ``min_lr_frac * lr``
    at ``total_steps``; a float32 value, as a Python float."""
    s = F32(step)
    warm = min(s / F32(max(cfg.warmup_steps, 1)), F32(1.0))
    prog = (F32(step - cfg.warmup_steps)
            / F32(max(cfg.total_steps - cfg.warmup_steps, 1)))
    prog = min(max(prog, F32(0.0)), F32(1.0))
    cos = F32(0.5) * (F32(1.0) + _cosf(F32(np.pi) * prog))
    frac = F32(cfg.min_lr_frac) + F32(1 - cfg.min_lr_frac) * cos
    return float(F32(cfg.lr) * warm * frac)


def tree_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of nested dicts and lists, in order; a
    path is the keys and indices joined by ``/``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_map(fn, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf, its structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def init_optimizer(cfg: OptimizerConfig, params: Any) -> AdamWState:
    mdt = MOMENT_DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    return AdamWState(step=0, m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum, over the leaves in order, of each leaf's sum of
    squares in float32: a 0-d float32 tensor."""
    total = None
    for _, x in tree_leaves(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_scale(cfg: OptimizerConfig, gnorm: torch.Tensor) -> torch.Tensor:
    """min(1, clip_norm / max(gnorm, 1e-9)) in float32 (a division of two
    tensors: ``scalar / tensor`` would be a reciprocal and a product)."""
    num = torch.full_like(gnorm, cfg.clip_norm)
    return torch.clamp(num / torch.clamp_min(gnorm, 1e-9), max=1.0)


@torch.no_grad()
def apply_updates(
    cfg: OptimizerConfig, params: Any, grads: Any, state: AdamWState
) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """One AdamW step; ``params``, ``state.m`` and ``state.v`` are updated in
    place and returned, with the new step and ``{"grad_norm", "lr"}``."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = clip_scale(cfg, gnorm)
    b1, b2 = cfg.betas
    lr = lr_at(cfg, step)
    bc1 = float(F32(1) - _powf(F32(b1), F32(step)))
    bc2 = float(F32(1) - _powf(F32(b2), F32(step)))
    leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                 tree_leaves(state.v))
    for (_, p), (_, g), (_, m), (_, v) in leaves:
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * torch.square(g)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, AdamWState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}
