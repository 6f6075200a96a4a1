"""Plain PyTorch version of Mamba's selective scan.

Counterpart of the scan in ``repro.models.mamba.mamba_forward``, which runs
it with ``lax.scan``: a loop over t in float32, each step as the reference
writes it,

    dec = exp(dt_t A)                         (B, d_in, n)
    h  <- dec h + (dt_t x_t) B_t              B_t scales column k
    y_t = h . C_t                             summed over k

and, after the loop, y + D x.  It forms ``exp(dt_t A)`` one step at a
time, never the (B, S, d_in, n) decay of the whole sequence.  The wrapper in
:mod:`.ops` runs this on a CPU tensor; on the card ``chip_smoke.py`` and the
``cuda`` tests hold ``csrc/selective_scan.cu`` against it.  It returns new
tensors and leaves ``state`` as it was.
"""

from __future__ import annotations

from typing import Tuple

import torch


def selective_scan_ref(
    x: torch.Tensor,  # (B, S, d_in)
    dt: torch.Tensor,  # (B, S, d_in), after softplus
    A: torch.Tensor,  # (d_in, n), -exp(A_log)
    Bm: torch.Tensor,  # (B, S, n)
    Cm: torch.Tensor,  # (B, S, n)
    D: torch.Tensor,  # (d_in,)
    state: torch.Tensor,  # (B, d_in, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (B, S, d_in) and the final state (B, d_in, n), both float32."""
    x, dt, A, Bm, Cm, D = (t.float() for t in (x, dt, A, Bm, Cm, D))
    h = state.float()
    ys = []
    for t in range(x.shape[1]):
        dec = torch.exp(dt[:, t, :, None] * A)
        h = dec * h + (dt[:, t] * x[:, t])[:, :, None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1) + D * x, h
