"""The WKV-6 recurrence and its gradient: the public wrappers.

Counterpart of ``repro.models.rwkv._wkv_scan``.  On a CUDA tensor
:func:`wkv6` launches ``csrc/wkv6.cu``, counted in ``wkv6.launches`` (and by
design in ``wkv6.designs``); on a CPU tensor it runs the plain version of
:mod:`.ref`.  There is no other path: a CUDA call that the kernel cannot
take (another head dim, another dtype, a non-contiguous input) raises.

Where autograd would record the call (grad mode on and an input that
requires grad) :func:`wkv6` is :class:`WKV6`, whose forward is the same
kernel, run on a fresh state tensor, and whose backward is
:func:`wkv6_bwd`: ``csrc/wkv6_bwd.cu`` on the card (two launches a call,
counted in ``wkv6_bwd.launches`` and by design in ``wkv6_bwd.designs``),
:func:`.ref.wkv6_bwd_ref` on the CPU.  Training starts from a state that
needs no gradient and drops the final state, as ``repro``'s
``_stack_forward`` does: a start state that requires grad, or a gradient
arriving into the final state, raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.kernel import (
    BWD_DESIGN,
    BWD_LAUNCHES,
    DESIGN,
    check_shapes,
    launch,
    launch_bwd,
)
from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref, wkv6_ref


def _forward(r, k, v, w, u, state) -> torch.Tensor:
    """y, with the final state written into ``state``: the kernel on the
    card, the plain version on the CPU."""
    if r.device.type == "cpu":
        y, final = wkv6_ref(r, k, v, w, u, state)
        state.copy_(final)
        return y
    y = launch(r, k, v, w, u, state)
    _build.counted(wkv6, DESIGN)
    return y


def wkv6(
    r: torch.Tensor,  # (B, S, H, n) float32
    k: torch.Tensor,  # (B, S, H, n) float32
    v: torch.Tensor,  # (B, S, H, n) float32
    w: torch.Tensor,  # (B, S, H, n) float32, the decay
    u: torch.Tensor,  # (H, n) float32
    state: torch.Tensor,  # (B, H, n, n) float32, updated in place
) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (B, S, H, n) and ``state``, into which the final state is written:
    prefill passes a zero state and any S, decode the cache's and S = 1.
    Under autograd (:class:`WKV6`) ``state`` is left as it was and the final
    state comes back as a new tensor."""
    check_shapes(r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u, state)):
        if state.requires_grad:
            raise RuntimeError("wkv6's backward gives the start state no gradient: training "
                               "starts from a state that does not require grad")
        return WKV6.apply(r, k, v, w, u, state)
    return _forward(r, k, v, w, u, state), state


wkv6.launches = 0
wkv6.designs = {}


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor, dy: torch.Tensor):
    """dr, dk, dv, dw (B, S, H, n) and du (H, n), float32: the gradient of
    :func:`wkv6`'s y given ``dy``, for a forward that started from
    ``state``.  Two launches on the card, each counted."""
    check_shapes(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return wkv6_bwd_ref(r, k, v, w, u, state, dy)
    out = launch_bwd(r, k, v, w, u, state, dy)
    for _ in range(BWD_LAUNCHES):
        _build.counted(wkv6_bwd, BWD_DESIGN)
    return out


wkv6_bwd.launches = 0
wkv6_bwd.designs = {}


class WKV6(torch.autograd.Function):
    """Training's recurrence: the forward is the kernel (the plain version
    on the CPU) from a copy of the start state, the backward
    :func:`wkv6_bwd`.  No gradient reaches the start state; one arriving
    into the final state raises."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.set_materialize_grads(False)
        final = state.clone()  # a fresh tensor: nothing autograd saved is written
        y = _forward(r, k, v, w, u, final)
        ctx.save_for_backward(r, k, v, w, u, state)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        if dfinal is not None:
            raise RuntimeError("wkv6's backward takes no gradient of the final state: training "
                               "drops it")
        r, k, v, w, u, state = ctx.saved_tensors
        return (*wkv6_bwd(r, k, v, w, u, state, dy.contiguous()), None)
