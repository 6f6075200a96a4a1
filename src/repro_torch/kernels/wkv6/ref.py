"""Plain PyTorch version of the WKV-6 recurrence.

Counterpart of ``repro.models.rwkv._wkv_scan``, which scans it with
``lax.scan``: a loop over t in float32, each step as the reference writes it,

    a   = k_t (outer) v_t                      (B, H, n, n)
    y_t = r_t . (S + u (.) a)                  u scales row i
    S  <- w_t (.) S + a                        w_t scales row i

The wrapper in :mod:`.ops` runs this on a CPU tensor; on the card
``chip_smoke.py`` and the ``cuda`` tests hold ``csrc/wkv6.cu`` against it.
It returns new tensors and leaves ``state`` as it was.
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
