"""PyTorch and CUDA port of the OGB caching reproduction.

The counterpart of ``repro`` for an NVIDIA H100, one slice at a time.
Ported so far: ``policy_def("ogb")`` replayed by ``run``, with Poisson,
Madow (``sample="madow"`` or ``"madow_tree"``) or no sampling, and the lazy
bucketized ``policy_def("ogb_tree")``.  The gradient histogram, every
capped-simplex catalog pass, every prefix-tree level and the bucket-mass
threshold solve are hand-written CUDA kernels (``repro_torch.kernels``)::

    from repro_torch import policy_def, run

    result = run(policy_def("ogb"), trace, catalog_size, capacity, window=1000)
    lazy = run(policy_def("ogb_tree"), trace, catalog_size, capacity, window=1000)

Entry points run on the CUDA card; pass ``device="cpu"`` to run the
kernels' plain PyTorch versions instead.
"""

from repro_torch.cachesim.api import (
    OGBCarry,
    OGBTreeCarry,
    PolicyDef,
    StepOut,
    carry_from_numpy,
    policy_def,
    run,
)

__all__ = [
    "OGBCarry",
    "OGBTreeCarry",
    "PolicyDef",
    "StepOut",
    "carry_from_numpy",
    "policy_def",
    "run",
]
