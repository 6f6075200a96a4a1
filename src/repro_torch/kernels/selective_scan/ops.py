"""Mamba's selective scan: the public wrapper.

Counterpart of the scan in ``repro.models.mamba.mamba_forward``.  On a
CUDA tensor it launches ``csrc/selective_scan.cu``, counted in
``selective_scan.launches`` and by design in ``selective_scan.designs``
(``kernel.design(S)``: the prefill design, or the decode step's at S = 1);
on a CPU tensor it runs the plain version of :mod:`.ref`.  There is no
other path: a CUDA call that the kernel cannot take (another state dim,
another dtype, a non-contiguous input) raises.  It has no backward: on a
CUDA tensor it raises where autograd would record it (grad mode on and an
input that requires grad).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.selective_scan.kernel import check_shapes, design, launch
from repro_torch.kernels.selective_scan.ref import selective_scan_ref


def selective_scan(
    x: torch.Tensor,  # (B, S, d_in) float32
    dt: torch.Tensor,  # (B, S, d_in) float32, after softplus
    A: torch.Tensor,  # (d_in, n) float32, -exp(A_log)
    Bm: torch.Tensor,  # (B, S, n) float32
    Cm: torch.Tensor,  # (B, S, n) float32
    D: torch.Tensor,  # (d_in,) float32
    state: torch.Tensor,  # (B, d_in, n) float32, updated in place
) -> torch.Tensor:
    """y (B, S, d_in); the final state is written into ``state``: prefill
    passes a zero state and any S, decode the cache's and S = 1."""
    check_shapes(x, dt, A, Bm, Cm, D, state)
    if x.device.type == "cpu":
        y, final = selective_scan_ref(x, dt, A, Bm, Cm, D, state)
        state.copy_(final)
        return y
    _build.refuse_grad("selective_scan", x, dt, A, Bm, Cm, D, state)
    y = launch(x, dt, A, Bm, Cm, D, state)
    _build.counted(selective_scan, design(x.shape[1]))
    return y


selective_scan.launches = 0
selective_scan.designs = {}
