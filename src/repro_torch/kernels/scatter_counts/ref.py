"""Plain PyTorch version of the request histogram.

Counterpart of ``repro.kernels.scatter_counts.ref.scatter_counts_ref``.
"""

from __future__ import annotations

import torch


def histogram_ref(ids: torch.Tensor, catalog_size: int) -> torch.Tensor:
    """counts[i] = #{t : ids[t] == i}; ids outside [0, catalog_size) are ignored."""
    valid = (ids >= 0) & (ids < catalog_size)
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    out = torch.zeros(catalog_size, dtype=torch.float32, device=ids.device)
    return out.index_add_(0, safe, valid.to(torch.float32))
