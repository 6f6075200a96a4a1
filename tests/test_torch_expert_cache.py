"""The port's expert-residency cache and serving loop against the JAX package's.

``policy_def("ogb_grad")`` from ``repro``'s own carry (its Poisson ``p``,
carried across with ``carry_from_numpy``): 200 steps of routed counts,
f and tau within 1e-5 every step, the reward within 1e-5, hits equal
where no f lies within 1e-5 of its p.  ``OGBExpertCache`` started from the
reference's carry gives the reference's step records; on its own seed it
passes the ports of ``tests/serve/test_serve.py``'s and
``tests/serve/test_serving_loop.py``'s expert-cache tests.  The
``ContinuousServingLoop`` under an injected clock gives the reference's
``ServingSLO`` on the same schedules, field by field.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.cachesim import api as japi
from repro.serve.engine import ContinuousServingLoop as JaxLoop
from repro.serve.expert_cache import ExpertCacheConfig as JaxConfig
from repro.serve.expert_cache import OGBExpertCache as JaxCache
import repro_torch
from repro_torch import (
    ContinuousServingLoop,
    ExpertCacheConfig,
    OGBExpertCache,
    ServingSLO,
    carry_from_numpy,
    policy_def,
)
from repro_torch.cachesim.scenarios import run_scenario
from repro_torch.jaxcache.fractional import poisson_sample

TOL = 1e-5


def _carry_np(carry):
    return {k: np.asarray(v) for k, v in carry._asdict().items()}


def _routes(steps, layers, experts, seed, shift_at=None):
    """Routed counts a step as the reference tests draw them: a quarter of
    each layer's experts hot (50-100 tokens), a few others lukewarm; the hot
    set moves at ``shift_at``."""
    rng = np.random.default_rng(seed)
    hot_n = experts // 4
    out = []
    for t in range(steps):
        start = 0 if shift_at is None or t < shift_at else experts // 2
        counts = np.zeros((layers, experts), np.float32)
        counts[:, start:start + hot_n] = rng.integers(50, 100, (layers, hot_n))
        for layer in range(layers):
            counts[layer, rng.integers(0, experts, 4)] += rng.integers(0, 10, 4)
        out.append(counts)
    return out


@pytest.mark.parametrize("n,c,eta,kind", [(128, 32, 0.2, "poisson"), (768, 192, 0.38, "shift"),
                                          (96, 48, 1.0, "poisson")])
def test_ogb_grad_matches_reference(n, c, eta, kind):
    jpd, pd = japi.policy_def("ogb_grad"), policy_def("ogb_grad")
    jc = jpd.init(n, c, seed=3, eta=eta)
    carry = carry_from_numpy(_carry_np(jc), "cpu")
    jstep = jax.jit(jpd.step)
    rng = np.random.default_rng(n)
    grads = (rng.poisson(5.0, (200, n)).astype(np.float32) if kind == "poisson"
             else np.stack(_routes(200, n // 32, 32, 4, shift_at=100)).reshape(200, n))
    for t, g in enumerate(grads):
        before = np.abs(np.asarray(jc.f) - np.asarray(jc.p))
        jc, jo = jstep(jc, jnp.asarray(g))
        carry, o = pd.step(carry, torch.from_numpy(g))
        np.testing.assert_allclose(carry.f.numpy(), np.asarray(jc.f), atol=TOL, rtol=0)
        assert abs(float(carry.tau) - float(jc.tau)) <= TOL, t
        assert abs(float(o.aux) - float(jo.aux)) <= TOL
        assert abs(float(o.reward) - float(jo.reward)) <= TOL, t
        if before.min() > TOL:
            assert int(o.hits) == int(jo.hits), t
        after = np.abs(np.asarray(jc.f) - np.asarray(jc.p))
        if after.min() > TOL:
            assert float(o.occupancy) == float(jo.occupancy), t
        assert int(carry.t) == int(jc.t) == t + 1
    assert abs(float(carry.f.sum()) - c) < 1e-3


def test_ogb_grad_init_and_where_it_runs():
    pd = policy_def("ogb_grad")
    assert pd.fractional and not pd.trace_driven and pd.kind == "ogb_grad"
    with pytest.raises(ValueError, match="sizes/costs"):
        pd.init(10, 2, eta=0.1, sizes=np.ones(10), device="cpu")
    with pytest.raises(ValueError, match="sizes/costs"):
        pd.init(10, 2, eta=0.1, costs=np.ones(10), device="cpu")
    with pytest.raises(ValueError, match="needs eta"):
        pd.init(10, 2, device="cpu")
    carry = pd.init(10, 4, seed=1, eta=0.5, device="cpu")
    np.testing.assert_array_equal(carry.f.numpy(), np.full(10, 0.4, np.float32))
    assert carry.p.shape == (10,) and float(carry.cap) == 4.0
    again = pd.init(10, 4, seed=1, eta=0.5, device="cpu")
    assert torch.equal(carry.p, again.p)  # the port's own seeded p
    assert policy_def("ogb_grad", iters=30).step is not pd.step
    traces = np.zeros((2, 100), np.int64)
    with pytest.raises(ValueError, match="not trace-driven"):
        repro_torch.run_fleet(pd, traces, 10, 2, window=50, device="cpu")
    # the scenario harness does not replay it; as in the reference, a host
    # policy of that name is then looked up, and there is none
    with pytest.raises(ValueError, match="unknown policy 'ogb_grad'"):
        run_scenario("fig2_adversarial", "mini", policies=["ogb_grad"], device="cpu")


def test_expert_cache_matches_reference_from_its_carry():
    cfg = dict(n_layers=4, n_experts=32, resident_fraction=0.25, horizon_steps=300,
               bytes_per_expert=1 << 20)
    ref = JaxCache(JaxConfig(**cfg), seed=5)
    ours = OGBExpertCache(ExpertCacheConfig(**cfg), device="cpu",
                          carry=carry_from_numpy(_carry_np(ref.carry), "cpu"))
    assert ours.eta == pytest.approx(ref.eta) and (ours.N, ours.C) == (ref.N, ref.C)
    assert float(ours.carry.eta) == np.float32(ref.eta)
    np.testing.assert_array_equal(ours.resident, ref.resident)
    for t, counts in enumerate(_routes(150, 4, 32, 6, shift_at=75)):
        near = np.abs(np.asarray(ref.carry.f) - np.asarray(ref.carry.p)).min() <= TOL
        want, got = ref.step(counts), ours.step(counts)
        near = near or np.abs(np.asarray(ref.carry.f) - np.asarray(ref.carry.p)).min() <= TOL
        assert abs(got["resident_hit_ratio"] - want["resident_hit_ratio"]) <= TOL, t
        if not near:
            assert {k: v for k, v in got.items() if k != "resident_hit_ratio"} == \
                {k: v for k, v in want.items() if k != "resident_hit_ratio"}, t
            np.testing.assert_array_equal(ours.resident_mask(), ref.resident_mask())
    assert ours.steps == ref.steps == 150
    assert abs(ours.mean_hit_ratio - ref.mean_hit_ratio) <= TOL
    assert ours.mean_hit_ratio > 0.4


def test_expert_cache_eta_and_carry_checks():
    cfg = ExpertCacheConfig(n_layers=61, n_experts=384, horizon_steps=1000)
    ours, ref = OGBExpertCache(cfg, device="cpu"), JaxCache(JaxConfig(**dataclasses.asdict(cfg)))
    assert (ours.N, ours.C, ours.eta) == (ref.N, ref.C, ref.eta) == (23424, 5856, ref.eta)
    assert ours.carry.f.device.type == "cpu"
    fixed = OGBExpertCache(dataclasses.replace(cfg, eta=0.5), device="cpu")
    assert fixed.eta == 0.5 == float(fixed.carry.eta)
    with pytest.raises(ValueError, match="experts"):
        OGBExpertCache(ExpertCacheConfig(n_layers=2, n_experts=8), carry=ours.carry)


# -- ports of tests/serve/test_serve.py's and test_serving_loop.py's cache tests --

def test_expert_cache_tracks_routing_shift():
    """Routing shifts mid-serve; the OGB placement follows it."""
    cfg = ExpertCacheConfig(n_layers=4, n_experts=32, resident_fraction=0.25,
                            horizon_steps=400)
    cache = OGBExpertCache(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)

    def route(phase):
        counts = np.zeros((4, 32))
        hot = np.arange(8) if phase == 0 else np.arange(16, 24)
        for layer in range(4):
            counts[layer, hot] = rng.integers(50, 100, size=8)
            counts[layer, rng.integers(0, 32, 4)] += rng.integers(0, 10, 4)
        return counts

    early = [cache.step(route(0))["resident_hit_ratio"] for _ in range(200)]
    late = [cache.step(route(1))["resident_hit_ratio"] for _ in range(200)]
    assert np.mean(late[-50:]) > 0.5
    assert np.mean(early[-50:]) > 0.5
    occ = cache.step(route(1))["occupancy"]
    assert abs(occ - cache.C) < 0.35 * cache.C  # soft capacity holds


def test_expert_cache_positive_coordination():
    cfg = ExpertCacheConfig(n_layers=2, n_experts=64, resident_fraction=0.25,
                            horizon_steps=300)
    cache = OGBExpertCache(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(3)
    counts = np.zeros((2, 64))
    counts[:, :16] = 10
    total_swaps = sum(cache.step(counts + rng.random((2, 64)))["swapped_in"]
                      for _ in range(100))
    # stationary routing => near-zero churn after warmup (coordinated samples)
    assert total_swaps < 0.3 * 100 * cache.C, total_swaps


def _shift_counts(hot, shape=(2, 32)):
    counts = np.zeros(shape, np.float32)
    counts[:, hot] = 100.0
    return counts


def test_swap_accounting_is_the_residency_mask_diff():
    bpe = 7_340_032
    cfg = ExpertCacheConfig(n_layers=2, n_experts=32, resident_fraction=0.25,
                            horizon_steps=100, bytes_per_expert=bpe)
    ec = OGBExpertCache(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tot_in = tot_out = 0
    for step in range(60):
        hot = np.arange(8) if step < 30 else np.arange(16, 24)
        counts = _shift_counts(hot) + rng.random((2, 32), np.float32)
        prev = ec.resident.copy()
        stats = ec.step(counts)
        new = ec.resident
        assert stats["swapped_in"] == int(np.sum(new & ~prev))
        assert stats["swapped_out"] == int(np.sum(prev & ~new))
        assert stats["hits"] == int(np.sum((counts.reshape(-1) > 0) & prev))
        assert stats["swap_bytes"] == (stats["swapped_in"] + stats["swapped_out"]) * bpe
        assert stats["resident_bytes"] == int(np.sum(new)) * bpe
        assert 0.0 <= stats["resident_hit_ratio"] <= 1.0
        tot_in += stats["swapped_in"]
        tot_out += stats["swapped_out"]
    assert ec.swapped_in == tot_in and ec.swapped_out == tot_out
    assert tot_in > 0 and tot_out > 0
    assert abs(tot_in - tot_out) < ec.C


def test_resident_recompute_routes_through_poisson_sample():
    cfg = ExpertCacheConfig(n_layers=2, n_experts=16, resident_fraction=0.5, horizon_steps=50)
    ec = OGBExpertCache(cfg, seed=3, device="cpu")
    ec.step(np.ones((2, 16), np.float32))
    direct = poisson_sample(ec.carry.f, ec.carry.p).numpy()
    np.testing.assert_array_equal(ec.resident, direct)
    ec._resident = None  # invalidate: the property must rebuild the mask
    np.testing.assert_array_equal(ec.resident, direct)
    np.testing.assert_array_equal(ec.resident_mask(), direct.reshape(2, 16))


def test_stationary_routing_has_near_zero_swap_bytes():
    bpe = 1 << 20
    cfg = ExpertCacheConfig(n_layers=2, n_experts=64, resident_fraction=0.25,
                            horizon_steps=300, bytes_per_expert=bpe)
    ec = OGBExpertCache(cfg, seed=1, device="cpu")
    counts = np.zeros((2, 64), np.float32)
    counts[:, :16] = 10.0
    rng = np.random.default_rng(3)
    swap_bytes = sum(ec.step(counts + rng.random((2, 64), np.float32))["swap_bytes"]
                     for _ in range(100))
    assert swap_bytes < 0.6 * 100 * ec.C * bpe


# -- the open loop, against the reference's on the same injected clock -------

class FakeTime:
    """Deterministic clock: sleeps and explicit service-time advances."""

    def __init__(self):
        self.t = 0.0

    def clock(self):
        return self.t

    def sleep(self, dt):
        assert dt > 0
        self.t += dt

    def busy(self, dt):
        self.t += dt


def _slo(loop_cls, service, batch_max, n, rate):
    fake, sizes = FakeTime(), []

    def decide(batch):
        sizes.append(len(batch))
        fake.busy(service(len(sizes)))

    slo = loop_cls(decide, batch_max=batch_max, clock=fake.clock, sleep=fake.sleep).run(
        list(range(n)), rate=rate)
    return slo, sizes


SCHEDULES = {
    "underloaded": (lambda i: 0.002, 1, 100, 100.0),
    "overloaded": (lambda i: 0.002, 1, 50, 1000.0),
    "batched": (lambda i: 0.004, 8, 64, 1000.0),
    "jittered": (lambda i: 0.0005 + 0.003 * (i % 7 == 0), 4, 300, 800.0),
}


@pytest.mark.parametrize("name", SCHEDULES)
def test_serving_loop_matches_reference(name):
    service, batch_max, n, rate = SCHEDULES[name]
    got, got_sizes = _slo(ContinuousServingLoop, service, batch_max, n, rate)
    want, want_sizes = _slo(JaxLoop, service, batch_max, n, rate)
    assert isinstance(got, ServingSLO) and got_sizes == want_sizes
    np.testing.assert_array_equal(got.latencies_ms, want.latencies_ms)
    fields = [f.name for f in dataclasses.fields(got) if f.name != "latencies_ms"]
    assert {k: getattr(got, k) for k in fields} == {k: getattr(want, k) for k in fields}
    assert got.requests == n and sum(got_sizes) == n


def test_underloaded_latency_is_the_service_time():
    slo, sizes = _slo(ContinuousServingLoop, lambda i: 0.002, 1, 100, 100.0)
    assert slo.requests == 100 and slo.steps == 100 and set(sizes) == {1}
    np.testing.assert_allclose(slo.latencies_ms, 2.0, rtol=1e-9)
    assert slo.p50_ms == pytest.approx(2.0) and slo.p99_ms == pytest.approx(2.0)
    assert slo.backlog_max == 1
    assert slo.seconds == pytest.approx(99 / 100.0 + 0.002)
    assert slo.req_per_sec == pytest.approx(100 / slo.seconds)


def test_overloaded_latency_grows_and_batching_drains_it():
    slo, _ = _slo(ContinuousServingLoop, lambda i: 0.002, 1, 50, 1000.0)
    expect = np.array([(i + 1) * 0.002 - i * 0.001 for i in range(50)])
    np.testing.assert_allclose(slo.latencies_ms, 1e3 * expect, rtol=1e-9)
    assert slo.backlog_max > 1 and np.all(np.diff(slo.latencies_ms) > 0)
    slo, sizes = _slo(ContinuousServingLoop, lambda i: 0.004, 8, 64, 1000.0)
    assert sum(sizes) == 64 and slo.steps == len(sizes) < 64 and max(sizes) >= 4
    assert slo.max_ms < 1e3 * (2 * 0.004 + 0.001)


def test_loop_rejects_bad_parameters():
    with pytest.raises(ValueError, match="batch_max"):
        ContinuousServingLoop(lambda b: None, batch_max=0)
    with pytest.raises(ValueError, match="rate"):
        ContinuousServingLoop(lambda b: None).run([1, 2], rate=0.0)


def test_loop_over_expert_cache_decisions():
    """The serving loop driving the cache, as the reference benchmark does:
    one step a payload, every request served, hit ratio above C/N."""
    cache = OGBExpertCache(ExpertCacheConfig(n_layers=2, n_experts=32, horizon_steps=100),
                           device="cpu")
    payloads = _routes(100, 2, 32, 9)
    fake = FakeTime()

    def decide(batch):
        cache.step(batch[0])
        fake.busy(0.001)

    slo = ContinuousServingLoop(decide, clock=fake.clock, sleep=fake.sleep).run(payloads, 700.0)
    assert slo.requests == cache.steps == 100 and slo.req_per_sec > 0.5 * 700.0
    assert cache.mean_hit_ratio > 0.25
