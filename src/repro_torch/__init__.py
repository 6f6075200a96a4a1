"""PyTorch and CUDA port of the OGB caching reproduction.

The counterpart of ``repro`` for an NVIDIA H100, one slice at a time.
Ported so far: ``policy_def("ogb")`` replayed by ``run``, with Poisson,
Madow (``sample="madow"`` or ``"madow_tree"``) or no sampling, the lazy
bucketized ``policy_def("ogb_tree")``, the paper's baselines ``omd``,
``lru``, ``fifo``, ``lfu`` and ``ftpl``, and the scenario harness
``cachesim.scenarios.run_scenario`` over the paper's comparison scenarios
(Figs. 2, 7, 8; ARC as its host oracle); and the dense model family's serving
path, ``serve.engine.ServeEngine`` behind an OGB page pool
(``serve.kvcache.PagedKVPool``), with its launcher
``python -m repro_torch.launch.serve``.  The gradient histogram, every
capped-simplex catalog pass, every prefix-tree level, the bucket-mass
threshold solve, a chunk of each automaton (the tree LRU, LFU and FTPL,
the default for those kinds, and the slot automaton), causal prefill
attention and one-token decode attention are hand-written CUDA kernels
(``repro_torch.kernels``)::

    from repro_torch import policy_def, run

    result = run(policy_def("ogb"), trace, catalog_size, capacity, window=1000)
    lazy = run(policy_def("ogb_tree"), trace, catalog_size, capacity, window=1000)
    lru = run(policy_def("lru"), trace, catalog_size, capacity, window=10_000)

    from repro_torch.cachesim.scenarios import run_scenario

    fig8 = run_scenario("fig8_cdn", "quick")  # one row a policy, and OPT(static)

    from repro_torch.configs.base import get_arch
    from repro_torch.core.policies import make_policy
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool

    cfg = get_arch("glm4-9b")
    pool = PagedKVPool(make_policy("ogb", 1 << 18, 4096, horizon=8192, batch_size=256),
                       page_size=64)
    engine = ServeEngine(cfg, init_params(cfg, dtype=torch.bfloat16), pool=pool,
                         max_len=2080)
    tokens = engine.generate(prompts, max_new_tokens=32)  # prompts: (B, S) int32

Entry points run on the CUDA card; pass ``device="cpu"`` to run the
kernels' plain PyTorch versions instead.
"""

from repro_torch.cachesim.api import (
    OGBCarry,
    OGBTreeCarry,
    OMDApiCarry,
    PolicyDef,
    StepOut,
    carry_from_numpy,
    policy_def,
    policy_def_kinds,
    run,
)

__all__ = [
    "OGBCarry",
    "OGBTreeCarry",
    "OMDApiCarry",
    "PolicyDef",
    "StepOut",
    "carry_from_numpy",
    "policy_def",
    "policy_def_kinds",
    "run",
]
