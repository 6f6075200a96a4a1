"""GQA flash attention for prefill, causal or not, and its gradient: the public wrappers.

Counterpart of ``repro.kernels.flash_prefill.ops.flash_prefill`` (causal)
and of ``repro``'s jnp ``flash_attention(causal=False)`` (an encoder's
self-attention, or cross-attention over T keys).  On a CUDA tensor
:func:`flash_prefill` launches ``csrc/flash_prefill.cu`` and counts it in
``flash_prefill.launches``, and by design and mode in
``flash_prefill.designs`` (``"wgmma+tma, causal"``, ``"cuda-core, cross"``,
...); on a CPU tensor it runs the plain version of :mod:`.ref`.  There is
no other path: a CUDA call that the kernel cannot take raises.

Training takes two more entry points, which ``models.attention``'s
autograd function calls: :func:`flash_prefill_lse`, the same kernel with
each row's log-sum-exp written beside the output (its wgmma design with P
split into bf16 hi + lo for the P V product, or the CUDA-core design;
counted in ``flash_prefill.launches``, its designs with ``", lse"`` at the
end), and :func:`flash_prefill_bwd`, the gradient, ``csrc/flash_prefill_bwd.cu``
(``csrc/flash_prefill_bwd_wgmma.cu``: bf16 at D in {64, 96, 128} on wgmma
and TMA, ``"wgmma+tma"``, three launches a call; everything else on CUDA
cores, two a call; counted in ``flash_prefill_bwd.launches``, and by design
and mode in ``flash_prefill_bwd.designs``).
:func:`flash_prefill` itself has no backward: on a CUDA tensor it raises
where autograd would record it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.kernel import (
    BWD_LAUNCHES,
    WGMMA,
    bwd_design,
    check_shapes,
    design,
    grid_prefill,
    grid_prefill_bwd,
    mode,
    train_design,
)
from repro_torch.kernels.flash_prefill.ref import (
    flash_prefill_bwd_ref,
    flash_prefill_lse_ref,
    flash_prefill_ref,
)


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
    _build.refuse_grad("flash_prefill", q, k, v)
    out = grid_prefill(q, k, v, causal)
    _build.counted(flash_prefill, f"{design(q.dtype, q.shape[3])}, {mode(q, k, causal)}")
    return out


flash_prefill.launches = 0
flash_prefill.designs = {}


def flash_prefill_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True):
    """Training's forward: the attention output and each row's float32
    log-sum-exp of its scaled scores, (B, H, S); one launch of the same
    kernel (``train_design``: the wgmma design with P split into bf16 hi +
    lo for its P V product, or the CUDA-core design), counted as one of
    ``flash_prefill``'s."""
    check_shapes(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_prefill_lse_ref(q, k, v, causal)
    B, S, H, D = q.shape
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    out = grid_prefill(q, k, v, causal, lse=lse, split_p=design(q.dtype, D) == WGMMA)
    _build.counted(flash_prefill, f"{train_design(q.dtype, D)}, {mode(q, k, causal)}, lse")
    return out, lse


def flash_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                      dout: torch.Tensor, lse: torch.Tensor, causal: bool = True):
    """The gradient of :func:`flash_prefill_lse`'s output: (dq, dk, dv) in
    q's type, from its output ``o``, the output's gradient ``dout`` and its
    ``lse``.  Three launches on the card (two of the CUDA-core design),
    each counted under its design's name."""
    check_shapes(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_prefill_bwd_ref(q, k, v, o, dout, lse, causal)
    out = grid_prefill_bwd(q, k, v, o, dout, lse, causal)
    which = bwd_design(q.dtype, q.shape[3])
    for _ in range(BWD_LAUNCHES[which]):
        _build.counted(flash_prefill_bwd, f"{which}, {mode(q, k, causal)}")
    return out


flash_prefill_bwd.launches = 0
flash_prefill_bwd.designs = {}
