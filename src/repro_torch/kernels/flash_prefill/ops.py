"""Causal GQA flash attention for prefill: the public wrapper.

Counterpart of ``repro.kernels.flash_prefill.ops.flash_prefill``.  On a
CUDA tensor it launches ``csrc/flash_prefill.cu`` and counts it in
``flash_prefill.launches``; on a CPU tensor it runs the plain version of
:mod:`.ref`.  There is no other path: a CUDA call that the kernel cannot
take raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_prefill.kernel import check_shapes, grid_prefill
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref


def flash_prefill(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,  # (B, S, Hkv, D)
) -> torch.Tensor:
    """Causal GQA attention over a whole prompt; (B, S, H, D) in q's type."""
    check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v)
    out = grid_prefill(q, k, v)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
