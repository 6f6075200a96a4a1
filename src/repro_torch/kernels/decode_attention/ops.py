"""GQA flash-decode attention: the public wrapper.

Counterpart of ``repro.kernels.decode_attention.ops.decode_attention``.  On
a CUDA tensor it launches ``csrc/decode_attention.cu`` (both passes, split
and combine, count as one launch in ``decode_attention.launches``); on a
CPU tensor it runs the plain version of :mod:`.ref`.  There is no other
path: a CUDA call that the kernel cannot take raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.kernel import check_shapes, grid_decode
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,  # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) int32, each in [1, S]
) -> torch.Tensor:
    """Single-token GQA attention over a padded KV cache; (B, H, D) in q's type.

    Query head h reads KV head h // (H / Hkv), as in the JAX package."""
    check_shapes(q, k, v, lengths)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    out = grid_decode(q, k, v, lengths)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
