"""GQA flash attention for prefill, causal or not: the public wrapper.

Counterpart of ``repro.kernels.flash_prefill.ops.flash_prefill`` (causal)
and of ``repro``'s jnp ``flash_attention(causal=False)`` (an encoder's
self-attention, or cross-attention over T keys).  On a CUDA tensor it
launches ``csrc/flash_prefill.cu`` and counts it in
``flash_prefill.launches``, and by design and mode in
``flash_prefill.designs`` (``"wgmma+tma, causal"``, ``"cuda-core, cross"``,
...); on a CPU tensor it runs the plain version of :mod:`.ref`.  There is
no other path: a CUDA call that the kernel cannot take raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.kernel import check_shapes, design, grid_prefill, mode
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref


def flash_prefill(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D); T == S where causal
    v: torch.Tensor,  # (B, T, Hkv, D)
    causal: bool = True,
) -> torch.Tensor:
    """GQA attention of S query rows over T keys, causal (T == S) or not;
    (B, S, H, D) in q's type."""
    check_shapes(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, causal)
    out = grid_prefill(q, k, v, causal)
    _build.counted(flash_prefill, f"{design(q.dtype, q.shape[3])}, {mode(q, k, causal)}")
    return out


flash_prefill.launches = 0
flash_prefill.designs = {}
