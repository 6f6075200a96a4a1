"""Plain PyTorch version of the WKV-6 recurrence.

Counterpart of ``repro.models.rwkv._wkv_scan``, which scans it with
``lax.scan``: a loop over t in float32, each step as the reference writes it,

    a   = k_t (outer) v_t                      (B, H, n, n)
    y_t = r_t . (S + u (.) a)                  u scales row i
    S  <- w_t (.) S + a                        w_t scales row i

The wrapper in :mod:`.ops` runs this on a CPU tensor; on the card
``chip_smoke.py`` and the ``cuda`` tests hold ``csrc/wkv6.cu`` against it.
It returns new tensors and leaves ``state`` as it was.

:func:`wkv6_bwd_ref` is the plain version of ``csrc/wkv6_bwd.cu``, the
gradient of y given dy = dL/dy, with G_t = dL/dS_t (G_T = 0: training drops
the final state), going backward over t (row index i of r, k, w, u; column
j of v):

    dv_t[j] = sum_i G_t[i,j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
    dk_t[i] = sum_j G_t[i,j] v_t[j] + r_t[i] u[i] (v_t . dy_t)
    dr_t[i] = sum_j S_{t-1}[i,j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
    dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
    du[i]  += r_t[i] k_t[i] (v_t . dy_t)          summed over b and t
    G_{t-1} = w_t[i] G_t + r_t[i] dy_t[j]

with the states S_{t-1} kept from a forward loop from ``state``.  dw is the
direct sum over G (.) S_{t-1}, what autodiff of the loop computes, not the
suffix-sum identity for d(log w) that divides by w and cancels over long
sequences.
"""

from __future__ import annotations

from typing import Tuple

import torch


def wkv6_ref(
    r: torch.Tensor,  # (B, S, H, n)
    k: torch.Tensor,  # (B, S, H, n)
    v: torch.Tensor,  # (B, S, H, n)
    w: torch.Tensor,  # (B, S, H, n), the decay in (0, 1)
    u: torch.Tensor,  # (H, n), the bonus of the current token
    state: torch.Tensor,  # (B, H, n, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (B, S, H, n) and the final state (B, H, n, n), both float32."""
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    s = state.float()
    ys = []
    for t in range(r.shape[1]):
        a = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], s + u[None, :, :, None] * a))
        s = w[:, t, :, :, None] * s + a
    return torch.stack(ys, dim=1), s


def wkv6_bwd_ref(
    r: torch.Tensor,  # (B, S, H, n)
    k: torch.Tensor,  # (B, S, H, n)
    v: torch.Tensor,  # (B, S, H, n)
    w: torch.Tensor,  # (B, S, H, n)
    u: torch.Tensor,  # (H, n)
    state: torch.Tensor,  # (B, H, n, n), the state the forward started from
    dy: torch.Tensor,  # (B, S, H, n), the gradient of y
) -> Tuple[torch.Tensor, ...]:
    """dr, dk, dv, dw (B, S, H, n) and du (H, n), float32; no gradient
    reaches ``state`` and none comes from the final state."""
    r, k, v, w, u, dy = (t.float() for t in (r, k, v, w, u, dy))
    s = state.float()
    before = []  # S_{t-1} of each step t
    for t in range(r.shape[1]):
        before.append(s)
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
    g = torch.zeros_like(s)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(r[:, 0])  # (B, H, n)
    for t in reversed(range(r.shape[1])):
        rt, kt, vt, wt, dyt = r[:, t], k[:, t], v[:, t], w[:, t], dy[:, t]
        c = (vt * dyt).sum(-1, keepdim=True)  # v_t . dy_t, (B, H, 1)
        ruk = (rt * u * kt).sum(-1, keepdim=True)
        dv[:, t] = torch.einsum("bhij,bhi->bhj", g, kt) + ruk * dyt
        dk[:, t] = torch.einsum("bhij,bhj->bhi", g, vt) + rt * u * c
        dr[:, t] = torch.einsum("bhij,bhj->bhi", before[t], dyt) + u * kt * c
        dw[:, t] = (g * before[t]).sum(-1)
        du += rt * kt * c
        g = wt[..., None] * g + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du.sum(0)
