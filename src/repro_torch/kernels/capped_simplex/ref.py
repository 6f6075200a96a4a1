"""Plain PyTorch versions of the capped-simplex catalog passes.

Counterparts of ``repro.kernels.capped_simplex.kernel``'s ``mass_kernel``
and ``apply_kernel``, and of the warm projection's whole threshold solve
and its epilogue (``csrc/mass.cu``'s ``repro_project_warm``).  They compute
``y = f + eta * counts`` with the same two roundings as the CUDA kernels,
so ``apply`` agrees bit for bit and ``masses`` up to float32 summation
order.
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


def project_warm_tau_ref(
    f: torch.Tensor,
    counts: torch.Tensor,
    eta: torch.Tensor,
    cap: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    tau0: torch.Tensor,
    sweeps: int,
) -> torch.Tensor:
    """tau after ``sweeps`` safeguarded Newton steps from clamp(tau0, lo, hi).

    g(tau) = sum(clip(y - tau, 0, 1)) is non-increasing with slope
    -#{i : 0 < y_i - tau < 1}.  Each sweep is one ``masses`` pass at K = 1,
    then the bracket shrinks and the Newton point ``tau + (g - C) / count``
    is taken if it has a count and lies in the bracket, else the midpoint.
    The safeguard is the reference's: it accepts a point equal to an end of
    the bracket.  The scalars are 0-d float32 tensors on f's device.
    """
    t = torch.clamp(tau0, lo, hi)
    for _ in range(sweeps):
        mass, cnt = masses_ref(f, counts, eta, t.reshape(1))
        mass, cnt = mass[0], cnt[0]
        too_much = mass >= cap
        lo = torch.where(too_much, t, lo)
        hi = torch.where(too_much, hi, t)
        t_newton = t + (mass - cap) / torch.clamp(cnt, min=1.0)
        t_mid = 0.5 * (lo + hi)
        ok = (cnt > 0.0) & (t_newton >= lo) & (t_newton <= hi)
        t = torch.where(ok, t_newton, t_mid)
    return t


def project_warm_ref(
    f: torch.Tensor,
    counts: torch.Tensor,
    eta: torch.Tensor,
    cap: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    tau0: torch.Tensor,
    sweeps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f', tau): :func:`project_warm_tau_ref`'s tau and :func:`apply_ref`
    at it."""
    tau = project_warm_tau_ref(f, counts, eta, cap, lo, hi, tau0, sweeps)
    return apply_ref(f, counts, eta, tau), tau


def warm_rows_ref(fn, f: torch.Tensor, counts: torch.Tensor, scalars, sweeps: int):
    """``fn`` (:func:`project_warm_tau_ref` or :func:`project_warm_ref`) over
    each row of a 2-D f, one row at a time: over the one (N,) ``counts`` (a
    sweep's grid) or over its own row of (R, N) ``counts`` (a fleet's
    tenants), each of the five ``scalars`` (R,)."""
    outs = [fn(f[r], counts[r] if counts.dim() == 2 else counts, *(x[r] for x in scalars), sweeps)
            for r in range(f.shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)
