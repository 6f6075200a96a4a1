"""Plain PyTorch versions of the capped-simplex catalog passes.

Counterparts of ``repro.kernels.capped_simplex.kernel``'s ``mass_kernel``
and ``apply_kernel``.  They compute ``y = f + eta * counts`` with the same
two roundings as the CUDA kernels, so ``apply`` agrees bit for bit and
``masses`` up to float32 summation order.
"""

from __future__ import annotations

from typing import Tuple

import torch


def masses_ref(
    f: torch.Tensor, counts: torch.Tensor, eta: torch.Tensor, taus: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mass[K], cnt[K]): sum(clip(y - tau_k, 0, 1)) and #{0 < y - tau_k < 1}."""
    y = f + eta * counts
    z = y[None, :] - taus[:, None]
    mass = torch.clamp(z, 0.0, 1.0).sum(dim=1)
    cnt = ((z > 0.0) & (z < 1.0)).sum(dim=1).to(torch.float32)
    return mass, cnt


def apply_ref(
    f: torch.Tensor, counts: torch.Tensor, eta: torch.Tensor, tau: torch.Tensor
) -> torch.Tensor:
    """clip(f + eta * counts - tau, 0, 1)."""
    return torch.clamp(f + eta * counts - tau, 0.0, 1.0)

