"""Plain PyTorch versions of the prefix-tree block reductions.

Counterparts of ``repro.kernels.prefix_tree.kernel``'s ``segsum_kernel``
and ``bucket_mass_kernel``.  The wrappers in :mod:`.kernel` run these on a
CPU tensor; on the card ``chip_smoke.py`` and the ``cuda`` tests hold the
CUDA kernels against them.  Each term is rounded as the kernels round it,
so they differ only in summation order: not at all for integer values,
and for the bucket masses, summed in float64 by both, only where a float64
sum rounds to float32 on a tie.
"""

from __future__ import annotations

import torch


def segment_sums_ref(values: torch.Tensor, out_size: int, radix: int) -> torch.Tensor:
    """(out_size,) sums of each group of ``radix`` consecutive values, the
    last group zero-padded."""
    pad = out_size * radix - values.shape[0]
    padded = torch.nn.functional.pad(values, (0, pad))
    return padded.reshape(out_size, radix).sum(dim=1)


def bucket_masses_ref(cnt: torch.Tensor, total: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """mass[k] = sum_b cnt_b * clip(mean_b - taus[k], 0, 1), with
    mean_b = total_b / cnt_b for a non-empty bucket and 0 otherwise; the
    float32 terms are summed in float64 and rounded once, as the kernel does.

    An empty bucket adds an exact 0, so only the non-empty ones are summed
    (a histogram of y is mostly empty)."""
    nonempty = torch.nonzero(cnt).reshape(-1)
    cnt, total = cnt.index_select(0, nonempty), total.index_select(0, nonempty)
    mean = torch.where(cnt > 0, total / torch.clamp(cnt, min=1.0), torch.zeros_like(total))
    z = torch.clamp(mean[None, :] - taus[:, None], 0.0, 1.0)
    return (cnt[None, :] * z).sum(dim=1, dtype=torch.float64).to(torch.float32)
