"""The WKV-6 recurrence: the public wrapper.

Counterpart of ``repro.models.rwkv._wkv_scan``.  On a CUDA tensor it
launches ``csrc/wkv6.cu``, counted in ``wkv6.launches`` (and by design in
``wkv6.designs``); on a CPU tensor it runs the plain version of
:mod:`.ref`.  There is no other path: a CUDA call that the kernel cannot
take (another head dim, another dtype, a non-contiguous input) raises.
It has no backward: on a CUDA tensor it raises where autograd would record
it (grad mode on and an input that requires grad).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.kernel import DESIGN, check_shapes, launch
from repro_torch.kernels.wkv6.ref import wkv6_ref


def wkv6(
    r: torch.Tensor,  # (B, S, H, n) float32
    k: torch.Tensor,  # (B, S, H, n) float32
    v: torch.Tensor,  # (B, S, H, n) float32
    w: torch.Tensor,  # (B, S, H, n) float32, the decay
    u: torch.Tensor,  # (H, n) float32
    state: torch.Tensor,  # (B, H, n, n) float32, updated in place
) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (B, S, H, n) and ``state``, into which the final state is written:
    prefill passes a zero state and any S, decode the cache's and S = 1."""
    check_shapes(r, k, v, w, u, state)
    if r.device.type == "cpu":
        y, final = wkv6_ref(r, k, v, w, u, state)
        state.copy_(final)
        return y, state
    _build.refuse_grad("wkv6", r, k, v, w, u, state)
    y = launch(r, k, v, w, u, state)
    _build.counted(wkv6, DESIGN)
    return y, state


wkv6.launches = 0
wkv6.designs = {}
