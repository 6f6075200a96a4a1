"""PyTorch and CUDA port of the OGB caching reproduction.

The counterpart of ``repro`` for an NVIDIA H100, one slice at a time.
Ported so far: ``policy_def("ogb")`` replayed by ``run``, with Poisson,
Madow (``sample="madow"`` or ``"madow_tree"``) or no sampling, the lazy
bucketized ``policy_def("ogb_tree")``, the paper's baselines ``omd``,
``lru``, ``fifo``, ``lfu`` and ``ftpl``, the sized axis (``gds``,
``ogb_sized``, byte hit ratios with ``run(..., sizes=)``), parameter
sweeps (``sweep``, a grid of combos in one launch a chunk where the kind
has a grid form; ``register_policy_def`` adds a kind), the classic host
baselines ``ogb_cl`` and ``omd_cl`` (``core.policies.make_policy``), and
the scenario harness ``cachesim.scenarios.run_scenario`` over the paper's
comparison scenarios (Figs. 2, 7, 8, and ``sized_cdn``; ARC as its host
oracle); trace files and out-of-core streams (``open_trace``,
``CatalogRemap``, ``run_stream``: any length in fixed memory, bit for bit a
one-shot ``run``); multi-tenant fleets (``run_fleet``,
``run_fleet_stream``, a row of ids a tenant in one launch a chunk where
the kind has a grid form, and the two-level ``run_edge_fleet`` with its
``edge_fleet_cdn`` scenario); and the dense model family's serving
path, ``serve.engine.ServeEngine`` behind an OGB page pool
(``serve.kvcache.PagedKVPool``), with its launcher
``python -m repro_torch.launch.serve``; the MoE family (granite-moe,
kimi-k2: ``models.moe``, the dense mixture and capacity dispatch) on the
same engine; and the expert-residency cache, ``OGBExpertCache`` over
``policy_def("ogb_grad")``, with the open-loop ``ContinuousServingLoop``
and its ``ServingSLO``.  The gradient histogram, every
capped-simplex catalog pass, every prefix-tree level, the bucket-mass
threshold solve, the sized solve, a chunk of each automaton (the tree
LRU, LFU, FTPL and GDS, the default for those kinds, the FIFO queue and
the slot automaton), causal prefill
attention and one-token decode attention are hand-written CUDA kernels
(``repro_torch.kernels``).  The attention families also train
(``train.train_step.make_train_step``, ``launch/train.py``), attention's
gradient a hand-written kernel too (``flash_prefill_bwd``)::

    from repro_torch import policy_def, run

    result = run(policy_def("ogb"), trace, catalog_size, capacity, window=1000)
    lazy = run(policy_def("ogb_tree"), trace, catalog_size, capacity, window=1000)
    lru = run(policy_def("lru"), trace, catalog_size, capacity, window=10_000)

    # a (seeds x etas x capacities) grid, one launch a chunk for all combos
    grid = sweep(policy_def("ogb"), trace, catalog_size, [12_500, 25_000, 50_000],
                 etas=[None, 0.05], seeds=[0, 1])
    grid.hit_ratios[grid.row(capacity=25_000, seed=1)]

    from repro_torch.cachesim.scenarios import run_scenario

    fig8 = run_scenario("fig8_cdn", "quick")  # one row a policy, and OPT(static)

    from repro_torch import CatalogRemap, open_trace, run_fleet, run_stream

    remap = CatalogRemap(max_items=catalog_size)
    streamed = run_stream(policy_def("ogb"), remap.remap(open_trace("trace.u32")),
                          catalog_size, capacity, window=1000, horizon=trace_length)
    fleet = run_fleet(policy_def("lru"), tenant_traces, catalog_size, capacity,
                      window=500)  # (E, T) ids: a row a tenant

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

    from repro_torch import ContinuousServingLoop, ExpertCacheConfig, OGBExpertCache

    experts = OGBExpertCache(ExpertCacheConfig(n_layers=24, n_experts=32,
                                               horizon_steps=1000))
    experts.step(routed_counts)  # (24, 32): the swaps, hits and hit ratio
    slo = ContinuousServingLoop(lambda batch: experts.step(batch[0])).run(payloads, rate)

Entry points run on the CUDA card; pass ``device="cpu"`` to run the
kernels' plain PyTorch versions instead.
"""

from repro_torch.cachesim.fleet import (
    run_edge_fleet,
    run_edge_fleet_scenario,
    run_fleet,
    run_fleet_stream,
)
from repro_torch.cachesim.results import (
    EdgeFleetResult,
    FleetResult,
    RunResult,
    StreamResult,
)
from repro_torch.cachesim.scenarios import EDGE_FLEET_SCENARIOS, get_edge_fleet_scenario
from repro_torch.cachesim.tracelab import (
    CatalogRemap,
    StreamFault,
    load_trace,
    open_trace,
    remap_trace,
    run_stream,
    tenant_streams,
    write_trace,
)
from repro_torch.serve.engine import ContinuousServingLoop, ServingSLO
from repro_torch.serve.expert_cache import ExpertCacheConfig, OGBExpertCache
from repro_torch.cachesim.api import (
    OGBCarry,
    OGBTreeCarry,
    OMDApiCarry,
    PolicyDef,
    StepOut,
    SweepResult,
    carry_from_numpy,
    policy_def,
    policy_def_kinds,
    register_policy_def,
    run,
    sweep,
)

__all__ = [
    "CatalogRemap",
    "ContinuousServingLoop",
    "ExpertCacheConfig",
    "OGBExpertCache",
    "ServingSLO",
    "EDGE_FLEET_SCENARIOS",
    "EdgeFleetResult",
    "FleetResult",
    "RunResult",
    "StreamFault",
    "StreamResult",
    "get_edge_fleet_scenario",
    "load_trace",
    "open_trace",
    "remap_trace",
    "run_edge_fleet",
    "run_edge_fleet_scenario",
    "run_fleet",
    "run_fleet_stream",
    "run_stream",
    "tenant_streams",
    "write_trace",
    "OGBCarry",
    "OGBTreeCarry",
    "OMDApiCarry",
    "PolicyDef",
    "StepOut",
    "SweepResult",
    "carry_from_numpy",
    "policy_def",
    "policy_def_kinds",
    "register_policy_def",
    "run",
    "sweep",
]
