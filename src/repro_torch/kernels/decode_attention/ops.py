"""GQA flash-decode attention: the public wrapper.

Counterpart of ``repro.kernels.decode_attention.ops.decode_attention``, and
of the int8 branch of ``repro``'s ``attention_decode`` (an int8 cache with
float32 scales, dequantized before the attention).  On a CUDA tensor it
launches ``csrc/decode_attention.cu`` (both passes, split and combine,
count as one launch in ``decode_attention.launches``, and by design and
cache in ``decode_attention.designs``: ``"mma.sync+cp.async, int8
cache"``, ...); on a CPU tensor it runs the plain version of :mod:`.ref`.
There is no other path: a CUDA call that the kernel cannot take raises.
It has no backward: on a CUDA tensor it raises where autograd would record
it (grad mode on and an input that requires grad).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.kernel import check_shapes, design, grid_decode
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D), q's type or int8 codes
    v: torch.Tensor,  # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) int32, each in [1, S]
    k_scale: Optional[torch.Tensor] = None,  # (B, S, Hkv) float32, with an int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token GQA attention over a padded KV cache; (B, H, D) in q's type.

    Query head h reads KV head h // (H / Hkv), as in the JAX package.  An
    int8 cache is attended as ``repro`` attends it: each code times its
    scale in float32, rounded to q's type."""
    check_shapes(q, k, v, lengths, k_scale, v_scale)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, k_scale, v_scale)
    _build.refuse_grad("decode_attention", q, k, v, k_scale, v_scale)
    out = grid_decode(q, k, v, lengths, k_scale, v_scale)
    cache = "int8 cache" if k_scale is not None else "compute-type cache"
    _build.counted(decode_attention, f"{design(q.dtype, q.shape[2])}, {cache}")
    return out


decode_attention.launches = 0
decode_attention.designs = {}
