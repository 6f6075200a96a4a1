"""Plain PyTorch version of the request histogram.

Counterpart of ``repro.kernels.scatter_counts.ref.scatter_counts_ref``.
"""

from __future__ import annotations

import torch


def histogram_ref(ids: torch.Tensor, catalog_size: int) -> torch.Tensor:
    """counts[i] = #{t : ids[t] == i}; ids outside [0, catalog_size) are ignored.

    (R, B) ids, a row of ids a tenant, give (R, catalog_size) counts, row
    by row."""
    if ids.dim() == 2:
        out = torch.zeros((ids.shape[0], catalog_size), dtype=torch.float32, device=ids.device)
        for r in range(ids.shape[0]):
            out[r] = histogram_ref(ids[r], catalog_size)
        return out
    valid = (ids >= 0) & (ids < catalog_size)
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    out = torch.zeros(catalog_size, dtype=torch.float32, device=ids.device)
    return out.index_add_(0, safe, valid.to(torch.float32))
