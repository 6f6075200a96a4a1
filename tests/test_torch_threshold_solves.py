"""The two persistent threshold solves' plain versions and planning, on the CPU.

The warm projection's solve (``project_warm_tau``, one launch of
``capped_simplex/csrc/mass.cu`` on the card) is held against
``repro.jaxcache.fractional.capped_simplex_project_warm``; the bucket solve
(``solve_buckets``, one launch of ``prefix_tree/csrc/bucket_mass.cu``)
against a float64 numpy bisection of the same bucket mass.  Inputs are made
with numpy from a seed.  Tolerances: tau within 1e-6 of the reference
(float32 sums in another order), as in test_torch_fractional.py; the bucket
solve within 1e-6 of the float64 root after 30 halvings, as in
test_torch_ogb_tree.py::test_solve_finds_the_float64_root.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.projection import capped_simplex_tau, project_capped_simplex
from repro.jaxcache import fractional as jfr
from repro_torch.jaxcache import fractional as tfr
from repro_torch.kernels import design_counts, launch_counts
from repro_torch.kernels.capped_simplex import ops as cs_ops
from repro_torch.kernels.capped_simplex.ref import project_warm_tau_ref
from repro_torch.kernels.prefix_tree import kernel as pt_kernel
from repro_torch.kernels.prefix_tree.ref import HALVINGS_PER_ROUND, solve_buckets_ref, solve_rounds

KERNELS = pathlib.Path(tfr.__file__).resolve().parents[1] / "kernels"


def _step(n, b, seed, eta):
    """Feasible f, the counts of b uniform ids, C, eta, and y in float32."""
    rng = np.random.default_rng(seed)
    c = max(2, n // 20)
    f = project_capped_simplex(rng.random(n) * (2 * c / n), c).astype(np.float32)
    counts = np.bincount(rng.integers(0, n, size=b), minlength=n).astype(np.float32)
    eta = np.float32(eta)
    return f, counts, c, eta, f + eta * counts


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _s(x):
    return torch.tensor(float(x), dtype=torch.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n,b,eta", [(500, 50, 0.05), (2000, 100, 0.01), (3000, 200, 0.2)])
def test_warm_tau_matches_the_reference_projection(n, b, eta, seed):
    f, counts, c, eta, y = _step(n, b, seed, eta)
    hi = float(jfr.warm_bracket_hi(eta * np.float32(b)))
    tau0 = 1.2 * capped_simplex_tau(y, c)
    args = (_t(f), _t(counts), _s(eta), _s(c), _s(0.0), _s(hi), _s(tau0), 5)
    plain = project_warm_tau_ref(*args)
    want_f, want_tau = jfr.capped_simplex_project_warm(jnp.asarray(y), float(c), 0.0, hi, tau0)
    assert abs(float(plain) - float(want_tau)) <= 1e-6
    # on the CPU the wrapper is the plain version
    assert torch.equal(cs_ops.project_warm_tau(*args), plain)
    got_f, got_tau = tfr.capped_simplex_project_warm(
        _t(f), _t(counts), float(eta), float(c), 0.0, hi, tau0
    )
    assert torch.equal(got_tau, plain)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0, atol=1e-5)


@pytest.mark.parametrize("sweeps", [1, 5, 25])
@pytest.mark.parametrize("start", ["lo", "hi"])
def test_warm_tau_sweeps_and_starts_match_the_reference(sweeps, start):
    f, counts, c, eta, y = _step(3000, 300, 5, 0.05)
    hi = float(jfr.warm_bracket_hi(eta * np.float32(300)))
    tau0 = 0.0 if start == "lo" else hi
    got = cs_ops.project_warm_tau(_t(f), _t(counts), float(eta), float(c), 0.0, hi, tau0, sweeps)
    _, want = jfr.capped_simplex_project_warm(jnp.asarray(y), float(c), 0.0, hi, tau0, sweeps)
    assert got.shape == () and got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6


def test_warm_tau_stops_at_zero_on_the_cycling_instance():
    # n=4, C=2, eta=0.5: the Newton point alternates between the bracket's
    # ends and the reference's safeguard accepts them, so it stops at tau=0
    y = np.array([1.0, 0.5, 1.5, 0.0], np.float32)
    zeros = torch.zeros(4)
    args = (_t(y), zeros, _s(0.5), _s(2.0), _s(0.0), _s(1.0), _s(0.5), 25)
    _, want = jfr.capped_simplex_project_warm(jnp.asarray(y), 2.0, 0.0, 1.0, 0.5, 25)
    assert float(want) == 0.0
    assert float(project_warm_tau_ref(*args)) == 0.0
    _, got = tfr.capped_simplex_project_warm(_t(y), zeros, 0.5, 2.0, 0.0, 1.0, 0.5, 25)
    assert float(got) == 0.0


def _histogram(v, seed):
    """(V,) bucket counts (70% empty) and sums with means spread over [-1, 2]."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 40, v).astype(np.float32)
    cnt[rng.random(v) < 0.7] = 0.0
    cnt[v // 2] = 7.0
    centre = -1.0 + (np.arange(v) + rng.random(v)) * (3.0 / v)
    return cnt, (cnt * centre).astype(np.float32)


def _mass64(cnt, total, tau):
    c, t = cnt.astype(np.float64), total.astype(np.float64)
    mean = np.where(c > 0, t / np.maximum(c, 1.0), 0.0)
    return float((c * np.clip(mean - tau, 0.0, 1.0)).sum())


def _solve(cnt, total, cap, lo, hi, iters):
    return solve_buckets_ref(_t(cnt), _t(total), _s(cap), _s(lo), _s(hi), iters)


@pytest.mark.parametrize("v", [1000, 65536])
def test_solve_buckets_finds_the_float64_root(v):
    cnt, total = _histogram(v, v)
    cap = 0.4 * float(cnt.sum())
    lo, hi = -1.5, 2.5
    got = _solve(cnt, total, cap, lo, hi, 30)
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if _mass64(cnt, total, mid) >= cap else (lo, mid)
    assert abs(float(got) - lo) <= 1e-6
    # on the CPU the wrapper is the plain version
    assert torch.equal(pt_kernel.solve_buckets(_t(cnt), _t(total), cap, -1.5, 2.5, 30), got)


@pytest.mark.parametrize("iters", [1, 6, 7])
def test_solve_buckets_lands_on_the_bisection_grid(iters):
    """After ``iters`` halvings the threshold is the last point of the
    2^iters-way grid over [lo, hi] whose mass is at least C."""
    cnt, total = _histogram(4096, iters)
    cap = 0.4 * float(cnt.sum())
    lo, hi = -1.5, 2.5
    got = float(_solve(cnt, total, cap, lo, hi, iters))
    m = 1 << iters
    k = round((got - lo) * m / (hi - lo))
    assert abs(got - (lo + (hi - lo) * k / m)) <= 1e-6
    assert _mass64(cnt, total, got) >= cap
    assert _mass64(cnt, total, lo + (hi - lo) * (k + 1) / m) < cap


@pytest.mark.parametrize("iters", [1, 6, 7, 30])
def test_solve_buckets_keeps_lo_where_its_mass_is_exactly_c(iters):
    # mass(1.0) = 4 * clip(2 - 1, 0, 1) = 4 = C, and below C past it
    cnt = np.array([4.0, 4.0], np.float32)
    total = np.array([4.0, 8.0], np.float32)
    assert float(_solve(cnt, total, 4.0, 1.0, 3.0, iters)) == 1.0


def test_solve_buckets_over_one_bucket():
    # one bucket of 10 items at mean 0.5: in exact arithmetic mass(tau) >= 5
    # for tau <= 0; in float32, while 0.5 - tau still rounds to 0.5
    got = _solve(np.array([10.0], np.float32), np.array([5.0], np.float32), 5.0, -1.0, 1.0, 30)
    t = np.float32(float(got))
    assert 0.0 <= t <= 2.0**-25
    assert np.float32(0.5) - t == np.float32(0.5)
    assert np.float32(0.5) - (t + np.float32(2.0**-29)) < np.float32(0.5)


def test_solve_rounds():
    assert HALVINGS_PER_ROUND == 6
    assert solve_rounds(0) == []
    assert solve_rounds(1) == [1]
    assert solve_rounds(6) == [6]
    assert solve_rounds(7) == [6, 1]
    assert solve_rounds(30) == [6] * 5


def _constant(source, name):
    text = (KERNELS / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_plan_constants_mirror_the_sources():
    assert cs_ops.WARM_THREADS == _constant("capped_simplex/csrc/mass.cu", "kWarmThreads")
    assert cs_ops.WARM_ITEMS == _constant("capped_simplex/csrc/mass.cu", "kWarmItems")
    src = "prefix_tree/csrc/bucket_mass.cu"
    assert pt_kernel.SOLVE_THREADS == _constant(src, "kSolveThreads")
    assert pt_kernel.SOLVE_CHIP_BUCKETS == _constant(src, "kChipBuckets")
    assert pt_kernel.SOLVE_POINTS == (1 << _constant(src, "kSolveHalvings")) - 1
    assert _constant(src, "kSolveHalvings") == HALVINGS_PER_ROUND


def test_warm_plan():
    # an H100: 132 SMs, one block of 1024 threads an SM, 8 items a thread:
    # 1e6 items are 123 fixed tiles of 8192, a block each
    plan = cs_ops.warm_plan(1_000_000, 5, 132, 1, 1)
    assert plan["blocks"] == 123 and plan["resident"] and plan["partials"] == 5 * 123
    assert plan["tiles"] == 123 and plan["per_block"] == 1
    assert plan["design"] == "persistent, y in registers"
    edge = 132 * 1024 * 8
    assert cs_ops.warm_plan(edge, 5, 132, 1, 1)["resident"]
    past = cs_ops.warm_plan(edge + 1, 25, 132, 1, 2)
    assert not past["resident"] and past["blocks"] == 133 and past["partials"] == 25 * 133
    assert past["design"] == "persistent, y re-read from L2"
    assert cs_ops.warm_plan(1, 1, 1, 1, 1)["resident"]
    # a sweep's 18 rows of 1e6: 2214 tiles, 9 a block over 2 blocks an SM
    grid = cs_ops.warm_plan(1_000_000, 5, 132, 1, 2, rows=18)
    assert not grid["resident"] and grid["per_block"] == 9 and grid["blocks"] == 246
    assert grid["partials"] == 5 * 18 * 123
    assert cs_ops.warm_plan(1_000_000, 5, 132, 1, 2, rows=1)["resident"]
    with pytest.raises(ValueError, match="rows"):
        cs_ops.warm_plan(10, 5, 1, 1, 1, rows=100)


@pytest.mark.parametrize("n, rows, sms, groups", [
    (1_000_000, 18, 132, [(0, 18)]),
    # 132 blocks of 64 tiles hold 68 rows of 123 tiles: 69 rows take two
    # launches of near-equal size
    (1_000_000, 69, 132, [(0, 35), (35, 69)]),
    (1_000_000, 200, 132, [(0, 67), (67, 134), (134, 200)]),
    (10_000_000, 7, 132, [(0, 4), (4, 7)]),
    # one row past 132 * 64 tiles: a launch of its own, its blocks in rounds
    (100_000_000, 1, 132, [(0, 1)]),
    (100_000_000, 3, 132, [(0, 1), (1, 2), (2, 3)]),
    (10, 100, 1, [(0, 50), (50, 100)]),
])
def test_warm_groups(n, rows, sms, groups):
    assert cs_ops.warm_groups(n, sms, 1, rows) == groups
    for r0, r1 in groups:
        plan = cs_ops.warm_plan(n, 5, sms, 1, 1, rows=r1 - r0)
        assert plan["blocks"] <= sms
        tiles = plan["tiles"]
        assert (plan["per_block"] + tiles - 2) // tiles + 1 <= cs_ops.WARM_ROWS_PER_BLOCK
        assert plan["blocks"] * plan["per_block"] >= (r1 - r0) * tiles
    single = cs_ops.warm_plan(n, 5, sms, 1, 1, rows=1)
    if n == 100_000_000:
        assert single["per_block"] > cs_ops.WARM_TILES_PER_BLOCK


def test_solve_plan():
    # an H100: 132 SMs, one block of 1024 threads an SM, 4096 buckets a block
    plan = pt_kernel.solve_plan(65536, 30, 132, 1, 1)
    assert plan["blocks"] == 132 and plan["on_chip"] and plan["rounds"] == 5
    assert plan["partials"] == 5 * 63 * 132
    assert plan["design"] == "persistent, means in shared memory"
    edge = 132 * 4096
    assert pt_kernel.solve_plan(edge, 7, 132, 1, 1)["on_chip"]
    past = pt_kernel.solve_plan(edge + 1, 7, 132, 1, 2)
    assert not past["on_chip"] and past["blocks"] == 264 and past["rounds"] == 2
    assert past["partials"] == 2 * 63 * 264
    assert past["design"] == "persistent, means re-read from L2"
    assert pt_kernel.solve_plan(1, 0, 132, 1, 1)["partials"] == 0


def test_cpu_path_counts_no_launches():
    before, designs = launch_counts(), design_counts()
    f, counts, c, eta, _y = _step(500, 50, 0, 0.05)
    tfr.capped_simplex_project_warm(_t(f), _t(counts), float(eta), float(c), 0.0, 3.0, 0.1)
    cs_ops.project_warm_tau(_t(f), _t(counts), float(eta), float(c), 0.0, 3.0, 0.1, 5)
    cnt, total = _histogram(1000, 0)
    pt_kernel.solve_buckets(_t(cnt), _t(total), 100.0, -1.5, 2.5, 30)
    assert launch_counts() == before
    assert design_counts() == designs


def test_other_devices_raise():
    f = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cs_ops.project_warm_tau(f, f, 0.1, 2.0, 0.0, 1.0, 0.5, 5)
    with pytest.raises(ValueError, match="CUDA"):
        pt_kernel.solve_buckets(f, f, 2.0, 0.0, 1.0, 30)
