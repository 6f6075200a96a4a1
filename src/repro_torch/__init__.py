"""PyTorch and CUDA port of the OGB caching reproduction.

The counterpart of ``repro`` for an NVIDIA H100, one slice at a time.  This
slice is the main path: ``policy_def("ogb")`` replayed by ``run``, with the
gradient histogram and every capped-simplex catalog pass in hand-written
CUDA kernels (``repro_torch.kernels``)::

    from repro_torch import policy_def, run

    result = run(policy_def("ogb"), trace, catalog_size, capacity, window=1000)

Entry points run on the CUDA card; pass ``device="cpu"`` to run the
kernels' plain PyTorch versions instead.
"""

from repro_torch.cachesim.api import (
    OGBCarry,
    PolicyDef,
    StepOut,
    carry_from_numpy,
    policy_def,
    run,
)

__all__ = ["OGBCarry", "PolicyDef", "StepOut", "carry_from_numpy", "policy_def", "run"]
