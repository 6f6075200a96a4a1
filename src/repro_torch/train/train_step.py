"""The training step: gradients, microbatching (gradient accumulation) and AdamW.

Counterpart of ``repro.train.train_step`` off a mesh.  A step runs
``forward_train`` and its backward once a microbatch (rows ``i * b / n``
.. of every batch entry, as the reference's reshape cuts them); the
float32 gradients add up in each parameter's ``.grad`` in microbatch order
(the reference's ``zeros + g_1 + g_2 ...``) and are divided by their count,
the loss is the microbatches' mean, then :func:`apply_updates` updates the
weights and the moments in place.  On the card every whole-sequence
attention of the forward (twice a layer under remat: the forward and its
recomputation) is a ``flash_prefill`` launch with its log-sum-exp, and
every layer's backward a ``flash_prefill_bwd`` call; an rwkv6 layer's
recurrence is a ``wkv6`` launch (twice under remat) and its backward a
``wkv6_bwd`` call.  The hybrid family raises ``NotImplementedError``
(``forward_train``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch._device import DeviceLike
from repro_torch.models.model import forward_train, init_params

from .optimizer import AdamWState, OptimizerConfig, apply_updates, init_optimizer, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def create_train_state(cfg, opt_cfg: OptimizerConfig, seed: int = 0,
                       device: DeviceLike = None) -> TrainState:
    """Random weights (``init_params``, in ``cfg.param_dtype``) that require
    grad, and zero moments."""
    params = tree_map(lambda t: t.requires_grad_(True), init_params(cfg, seed, device))
    return TrainState(params=params, opt=init_optimizer(opt_cfg, params))


def _microbatch(batch: Dict[str, Any], i: int, n: int) -> Dict[str, Any]:
    out = {}
    for key, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not split into {n} microbatches")
        out[key] = x[i * (b // n):(i + 1) * (b // n)]
    return out


def _grads(params: Any) -> Any:
    """Each parameter's ``.grad``; zeros for one that got none (unused)."""
    return tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p), params)


def make_train_step(cfg, opt_cfg: OptimizerConfig, n_microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics); the state's
    tensors are updated in place.  ``metrics`` holds ``loss``,
    ``grad_norm`` (0-d tensors) and ``lr`` (a float), and with one
    microbatch ``forward_train``'s metrics."""

    def train_step(state: TrainState, batch: Dict[str, Any]) -> Tuple[TrainState, Dict]:
        tree_map(lambda p: setattr(p, "grad", None), state.params)
        metrics: Dict[str, Any] = {}
        if n_microbatches == 1:
            loss, metrics = forward_train(cfg, state.params, batch)
            loss.backward()
            grads = _grads(state.params)
        else:
            loss_sum = None
            for i in range(n_microbatches):
                loss_i, _ = forward_train(cfg, state.params, _microbatch(batch, i, n_microbatches))
                loss_i.backward()
                loss_i = loss_i.detach()
                loss_sum = loss_i if loss_sum is None else loss_sum + loss_i
            grads = tree_map(lambda g: g.div_(n_microbatches), _grads(state.params))
            loss = loss_sum / n_microbatches
        params, opt, opt_metrics = apply_updates(opt_cfg, state.params, grads, state.opt)
        tree_map(lambda p: setattr(p, "grad", None), params)
        out = {"loss": loss.detach(), **opt_metrics}
        out.update({k: v.detach() for k, v in metrics.items()})
        return TrainState(params=params, opt=opt), out

    return train_step
