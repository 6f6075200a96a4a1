"""The port's fleet against E independent runs, and against repro's fleet.

Mirrors ``tests/cachesim/test_fleet.py`` on the CPU (the kernels' plain
versions): every trace-driven kind's fleet row is bit for bit its tenant's
own ``repro_torch.run`` (hits, reward, aux, occupancy and every final
carry leaf), the grid kinds stepping all tenants at once over a row of ids
each, the others tenant by tenant; fleet rows equal sweep rows on a shared
trace; resume, per-tenant eta and ragged rejection; the streamed fleet
equals the in-memory one; and the two-level edge fleet keeps its
invariants and, at ``edge_fleet_cdn`` mini, matches ``repro``'s (the
automata exactly; the ``ogb`` origin from ``repro``'s own Poisson ``p``
within the dense path's tolerances).
"""

import numpy as np
import pytest
import torch

import jax

from repro.cachesim import api as japi
from repro.cachesim import fleet as jfleet
import repro_torch
from repro_torch.cachesim import fleet as tfleet
from repro_torch.cachesim.api import PolicyDef
from repro_torch.cachesim.fleet import (
    run_edge_fleet,
    run_edge_fleet_scenario,
    run_fleet,
    run_fleet_stream,
)
from repro_torch.cachesim.tracelab import StreamFault, fit_profile, run_stream, tenant_streams
from repro_torch.cachesim.traces import make_trace
from repro_torch.core.ogb import theoretical_eta

N, W, T, E = 128, 50, 600, 3
CAPS = [8, 16, 12]
SEEDS = [3, 4, 5]
TRACE_KINDS = ("ogb", "ogb_tree", "omd", "lru", "lfu", "fifo", "ftpl", "gds")
SIZED_KINDS = ("gds", "ogb_sized")
CPU = "cpu"


@pytest.fixture(scope="module")
def traces():
    return np.stack([make_trace("zipf", N, T, seed=7 + e, alpha=0.8) for e in range(E)])


@pytest.fixture(scope="module")
def sizes():
    rng = np.random.default_rng(0)
    return rng.choice([1.0, 4.0, 16.0], size=N).astype(np.float64)


def _tensors(carry):
    if isinstance(carry, torch.Tensor):
        return [carry]
    if isinstance(carry, (tuple, list)):
        return [t for x in carry for t in _tensors(x)]
    return []


def _assert_rows_equal(fr, results):
    for e, r in enumerate(results):
        for a in ("hits", "reward", "aux", "occupancy"):
            np.testing.assert_array_equal(getattr(fr, a)[e], getattr(r, a), err_msg=f"{e} {a}")


def _assert_carries_equal(carries, results):
    assert len(carries) == len(results)
    for e, r in enumerate(results):
        got, want = _tensors(carries[e]), _tensors(r.carry)
        assert type(carries[e]) is type(r.carry) and len(got) == len(want) > 0
        for x, y in zip(got, want):
            assert torch.equal(x, y), f"tenant {e}"


@pytest.mark.parametrize("kind", TRACE_KINDS)
def test_fleet_matches_independent_runs(kind, traces):
    pd = repro_torch.policy_def(kind)
    fr = run_fleet(pd, traces, N, CAPS, window=W, seeds=SEEDS, device=CPU)
    results = [repro_torch.run(pd, traces[e], N, CAPS[e], window=W, seed=SEEDS[e],
                               n_slots=max(CAPS), device=CPU) for e in range(E)]
    _assert_rows_equal(fr, results)
    _assert_carries_equal(fr.carry, results)
    np.testing.assert_allclose(fr.opt_hits, [r.opt_hits for r in results])
    assert fr.n_tenants == E and fr.T == T and fr.total_requests == E * T
    assert fr.hit_ratio == pytest.approx(fr.hits.sum() / (E * T))


@pytest.mark.parametrize("kind", SIZED_KINDS + ("lru", "fifo"))
def test_sized_fleet_matches_independent_runs(kind, traces, sizes):
    pd = repro_torch.policy_def(kind)
    fr = run_fleet(pd, traces, N, CAPS, window=W, seeds=SEEDS, sizes=sizes, device=CPU)
    results = [repro_torch.run(pd, traces[e], N, CAPS[e], window=W, seed=SEEDS[e],
                               n_slots=max(CAPS), sizes=sizes, device=CPU) for e in range(E)]
    _assert_rows_equal(fr, results)
    assert fr.byte_hits is not None
    for e, r in enumerate(results):
        np.testing.assert_array_equal(fr.byte_hits[e], r.byte_hits)
        assert fr.bytes_total[e] == r.bytes_total
    assert 0.0 < fr.byte_hit_ratio <= 1.0


@pytest.mark.parametrize("kind", ("ogb", "lru", "lfu", "fifo"))
def test_fleet_matches_sweep_on_shared_trace(kind, traces):
    """The same trace for every tenant: the fleet's rows are the sweep's."""
    pd = repro_torch.policy_def(kind)
    caps = (4, 8, 16)
    sw = repro_torch.sweep(pd, traces[0], N, caps, seeds=(0,), window=W, device=CPU)
    fr = run_fleet(pd, np.stack([traces[0]] * len(caps)), N, list(caps), window=W, seeds=0,
                   horizons=T, device=CPU)
    for i in range(len(caps)):
        j = sw.row(capacity=caps[i])
        np.testing.assert_array_equal(fr.hits[i], sw.hits[j])
        np.testing.assert_array_equal(fr.aux[i], sw.aux[j])
        for x, y in zip(_tensors(fr.carry[i]), _tensors(sw.carries[j])):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ("ogb", "lru", "fifo", "omd"))
def test_fleet_resume_mid_stream(kind, traces):
    pd = repro_torch.policy_def(kind)
    half = T // 2
    full = run_fleet(pd, traces, N, CAPS, window=W, seeds=SEEDS, track_opt=False, device=CPU)
    r1 = run_fleet(pd, traces[:, :half], N, CAPS, window=W, seeds=SEEDS, horizons=T,
                   track_opt=False, device=CPU)
    r2 = run_fleet(pd, traces[:, half:], carry=r1.carry, capacities=CAPS, window=W,
                   track_opt=False, device=CPU)
    np.testing.assert_array_equal(np.concatenate([r1.hits, r2.hits], axis=1), full.hits)
    np.testing.assert_array_equal(np.concatenate([r1.reward, r2.reward], axis=1), full.reward)
    for a, b in zip(r2.carry, full.carry):
        for x, y in zip(_tensors(a), _tensors(b)):
            assert torch.equal(x, y)


def test_fleet_rejections(traces):
    pd = repro_torch.policy_def("ogb")
    r = run_fleet(pd, traces, N, CAPS, window=W, track_opt=False, device=CPU)
    with pytest.raises(ValueError, match="resumes with"):
        run_fleet(pd, traces, window=W, carry=r.carry, seeds=SEEDS, device=CPU)
    with pytest.raises(ValueError, match="tenant"):
        run_fleet(pd, traces[:2], window=W, carry=r.carry, device=CPU)
    with pytest.raises(ValueError, match="equal length"):
        run_fleet(pd, [np.zeros(100, int), np.zeros(150, int)], N, 8, window=W, device=CPU)
    with pytest.raises(ValueError, match="shorter than one window"):
        run_fleet(pd, np.zeros((2, W - 1), int), N, 8, window=W, device=CPU)
    with pytest.raises(ValueError, match="capacities"):
        run_fleet(pd, traces, N, [8, 8], window=W, device=CPU)
    with pytest.raises(NotImplementedError, match="mesh"):
        run_fleet(pd, traces, N, 8, window=W, mesh=object(), device=CPU)
    host_only = PolicyDef(kind="host", name="HOST", init=pd.init, step=pd.step,
                          trace_driven=False)
    with pytest.raises(ValueError, match="trace-driven"):
        run_fleet(host_only, traces, N, 8, window=W, device=CPU)


def test_default_eta_resolves_per_tenant(traces):
    """A tenant replaying a T-slice gets the Theorem 3.1 rate at its own
    horizon, not at the fleet's aggregate E * T."""
    pd = repro_torch.policy_def("ogb")
    fr = run_fleet(pd, traces, N, CAPS, window=W, track_opt=False, device=CPU)
    assert fr.etas is not None and fr.etas.shape == (E,)
    for e in range(E):
        assert fr.etas[e] == pytest.approx(theoretical_eta(CAPS[e], N, T, 1), rel=1e-12)
        assert fr.etas[e] != pytest.approx(theoretical_eta(CAPS[e], N, E * T, 1), rel=1e-6)
        assert float(fr.carry[e].eta) == np.float32(fr.etas[e])
    hor = [T, 2 * T, 4 * T]
    fr2 = run_fleet(pd, traces, N, CAPS, window=W, horizons=hor, track_opt=False, device=CPU)
    for e in range(E):
        assert fr2.etas[e] == pytest.approx(theoretical_eta(CAPS[e], N, hor[e], 1), rel=1e-12)
    fr3 = run_fleet(pd, traces, N, CAPS, window=W, etas=[0.01, None, 0.2], track_opt=False,
                    device=CPU)
    assert fr3.etas[0] == 0.01 and fr3.etas[2] == 0.2
    assert fr3.etas[1] == pytest.approx(theoretical_eta(CAPS[1], N, T, 1), rel=1e-12)


@pytest.mark.parametrize("kind", ("ogb", "lru", "gds"))
@pytest.mark.parametrize("prefetch", (0, 2))
def test_fleet_stream_matches_in_memory(kind, prefetch, traces):
    """Ragged prime-sized source chunks re-batch to the same replay."""
    pd = repro_torch.policy_def(kind)
    fr = run_fleet(pd, traces, N, CAPS, window=W, seeds=SEEDS, track_opt=False, device=CPU)
    sources = [[traces[e][i:i + 97] for i in range(0, T, 97)] for e in range(E)]
    fs = run_fleet_stream(pd, sources, N, CAPS, window=W, seeds=SEEDS, horizons=T,
                          prefetch=prefetch, segment_len=200, device=CPU)
    np.testing.assert_array_equal(fs.hits, fr.hits)
    np.testing.assert_array_equal(fs.reward, fr.reward)
    assert fs.n_segments == 3 and fs.t_dropped == 0 and fs.prefetch == prefetch
    for a, b in zip(fs.carry, fr.carry):
        for x, y in zip(_tensors(a), _tensors(b)):
            assert torch.equal(x, y)


def test_fleet_stream_truncates_ragged_sources(traces):
    """Unequal tenants truncate to the shortest window-aligned length."""
    pd = repro_torch.policy_def("ogb")
    sources = [[traces[0][:500]], [traces[1][:350]], [traces[2][:600]]]
    fs = run_fleet_stream(pd, sources, N, CAPS, window=W, seeds=SEEDS, horizons=T, prefetch=0,
                          device=CPU)
    assert fs.T == 350
    assert fs.t_dropped == (500 - 350) + 0 + (600 - 350)
    fr = run_fleet(pd, traces[:, :350], N, CAPS, window=W, seeds=SEEDS, horizons=T,
                   track_opt=False, device=CPU)
    np.testing.assert_array_equal(fs.hits, fr.hits)
    with pytest.raises(ValueError, match="horizons"):
        run_fleet_stream(pd, sources, N, CAPS, window=W, device=CPU)


def test_fleet_stream_synthesized_tenants():
    """tenant_streams sources replay as their materialization does, and the
    streamed OPT is the in-memory one."""
    pd = repro_torch.policy_def("ogb")
    profile = fit_profile(make_trace("zipf", N, 4000, seed=11, alpha=0.8))
    t_s, e_s, cap = 300, 2, 12
    fs = run_fleet_stream(pd, tenant_streams(profile, e_s, t_s, catalog=N, base_seed=5), N,
                          cap, window=W, horizons=t_s, track_opt=True, device=CPU)
    mem = np.stack([np.concatenate(list(tenant_streams(profile, e_s, t_s, catalog=N,
                                                       base_seed=5)[e])) for e in range(e_s)])
    fr = run_fleet(pd, mem, N, cap, window=W, horizons=t_s, device=CPU)
    np.testing.assert_array_equal(fs.hits, fr.hits)
    np.testing.assert_allclose(fs.opt_hits, fr.opt_hits)


@pytest.mark.parametrize("prefetch", (0, 2))
def test_fleet_stream_fault_carries_partial(traces, prefetch):
    def bad_source():
        yield traces[0][:200]
        raise OSError("disk gone")

    sources = [bad_source(), [traces[1]], [traces[2]]]
    with pytest.raises(StreamFault) as ei:
        run_fleet_stream(repro_torch.policy_def("ogb"), sources, N, CAPS, window=W,
                         horizons=T, prefetch=prefetch, segment_len=100, device=CPU)
    fault = ei.value
    assert isinstance(fault.__cause__, OSError)
    part = fault.partial
    assert part is not None and part.T == 200 and fault.t_replayed == E * 200
    assert part.n_segments == 2 and len(part.carry) == E
    # the partial resumes: the rest equals the in-memory fleet
    full = run_fleet(repro_torch.policy_def("ogb"), traces, N, CAPS, window=W, horizons=T,
                     track_opt=False, device=CPU)
    rest = run_fleet(repro_torch.policy_def("ogb"), traces[:, 200:], carry=part.carry,
                     window=W, track_opt=False, device=CPU)
    np.testing.assert_array_equal(np.concatenate([part.hits, rest.hits], axis=1), full.hits)


@pytest.mark.parametrize("kind", tfleet.FLAG_KINDS)
def test_edge_fleet_invariants(kind, traces):
    ef = run_edge_fleet(kind, "ogb", traces, N, 8, 32, window=W, device=CPU)
    # edge rows are exactly independent per-edge replays
    pd = repro_torch.policy_def(kind)
    for e in range(E):
        r = repro_torch.run(pd, traces[e], N, 8, window=W, seed=e, device=CPU)
        np.testing.assert_array_equal(ef.edges.hits[e], r.hits)
        np.testing.assert_array_equal(ef.edges.reward[e], r.reward)
        for x, y in zip(_tensors(ef.edges.carry[e]), _tensors(r.carry)):
            assert torch.equal(x, y)
    # conservation: every edge miss, and only those, reaches the origin
    assert ef.origin_requests == E * T - int(ef.edges.hits.sum())
    assert ef.origin.T == (ef.origin_requests // W) * W
    assert 0.0 < ef.end_to_end_hit_ratio <= 1.0
    assert ef.end_to_end_hit_ratio >= ef.edge_hit_ratio
    assert ef.origin_hit_ratio == ef.origin.hit_ratio


def test_edge_fleet_interleave_and_repeat(traces):
    _, _, flags, _ = tfleet._edge_tier("lru", traces, W, N, np.full(E, 8), np.arange(E), None,
                                       torch.device(CPU))
    ids = traces.reshape(E, -1, W)
    misses = np.concatenate(list(tfleet._miss_chunks(ids, flags)))
    # arrival position major, edge minor
    want = [ids[e, c, w] for c in range(ids.shape[1]) for w in range(W) for e in range(E)
            if not flags[e, c, w]]
    np.testing.assert_array_equal(misses, want)
    a = run_edge_fleet("lru", "ogb", traces, N, 8, 32, window=W, prefetch=0, device=CPU)
    b = run_edge_fleet("lru", "ogb", traces, N, 8, 32, window=W, prefetch=2, device=CPU)
    np.testing.assert_array_equal(a.origin.hits, b.origin.hits)
    np.testing.assert_array_equal(a.origin.reward, b.origin.reward)


def test_edge_fleet_cdn_mini_matches_reference():
    """edge_fleet_cdn at mini: the edges (the tree LRU) are repro's exactly;
    the ogb origin over the port's miss stream, from repro's own initial
    carry (its Poisson p), within the dense path's tolerances."""
    got = run_edge_fleet_scenario("edge_fleet_cdn", "mini", device=CPU)
    with jax.threefry_partitionable(False):
        want = jfleet.run_edge_fleet_scenario("edge_fleet_cdn", "mini")
        sc = repro_torch.get_edge_fleet_scenario("edge_fleet_cdn")
        _e, n, _t, c_edge, c_origin = sc.dims("mini")
        jpd = japi.policy_def("ogb")
        eta = jpd.default_eta(n, c_origin, want.origin_requests, sc.window)
        carry = jpd.init(n, c_origin, seed=0, eta=eta, horizon=want.origin_requests)
        leaves = {k: np.asarray(v) for k, v in carry._asdict().items()}
    np.testing.assert_array_equal(got.edges.hits, want.edges.hits)
    np.testing.assert_array_equal(got.edges.reward, want.edges.reward)
    np.testing.assert_array_equal(got.edges.occupancy, want.edges.occupancy)
    np.testing.assert_allclose(got.edges.opt_hits, want.edges.opt_hits)
    assert got.origin_requests == want.origin_requests and got.origin.T == want.origin.T
    assert got.origin.opt_hits == want.origin.opt_hits
    assert got.edges.hit_ratio_p5 == pytest.approx(want.edges.hit_ratio_p5)
    assert got.edges.hit_ratio_p95 == pytest.approx(want.edges.hit_ratio_p95)
    traces = sc.make_edge_traces("mini")
    _, _, flags, _ = tfleet._edge_tier("lru", traces, sc.window, n, np.full(len(traces), c_edge),
                                       np.arange(len(traces)), None, torch.device(CPU))
    origin = run_stream(repro_torch.policy_def("ogb"),
                        tfleet._miss_chunks(traces.reshape(len(traces), -1, sc.window), flags),
                        capacity=c_origin, window=sc.window,
                        carry=repro_torch.carry_from_numpy(leaves, CPU), prefetch=0, device=CPU)
    assert origin.T == want.origin.T
    np.testing.assert_allclose(origin.aux, want.origin.aux, rtol=0, atol=1e-6)
    np.testing.assert_allclose(origin.reward, want.origin.reward, rtol=1e-5, atol=0)
    assert abs(int(origin.hits.sum()) - int(want.origin.hits.sum())) <= max(1, origin.T // 10_000)
