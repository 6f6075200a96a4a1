"""The scenario path as a whole: repro_torch's run_scenario against the goldens.

For each of the seven unsized scenarios with a policy set, the port's
``run_scenario(name, "mini", device="cpu")`` (every kernel's plain version)
is held to the committed golden of the JAX package
(``tests/cachesim/golden/<name>.json``) with ``test_golden.py``'s
tolerances: the automata, ARC and OPT(static) rows exactly, the OGB and OMD
regrets within FLOAT_ATOL * T.  Their hit ratios depend on the Poisson
``p``, which the port draws from its own stream; so they are held to the
golden from the reference's own initial carry, derived under
``jax.threefry_partitionable(False)`` (the stream the goldens were made
with) and carried across with ``carry_from_numpy``.
"""

import json
import os

import jax
import numpy as np
import pytest

from repro.cachesim import api as japi
import repro_torch
from repro_torch.cachesim import scenarios as tscen

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "cachesim", "golden")
GOLDEN_SCENARIOS = sorted(
    name for name, sc in tscen.SCENARIOS.items() if sc.policies and not sc.sized
)
EXACT_ATOL = 1e-12
FLOAT_ATOL = 5e-3
FLOAT_ROWS = ("OGB", "OMD")


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def minis():
    return {name: tscen.run_scenario(name, "mini", device="cpu") for name in GOLDEN_SCENARIOS}


def test_the_seven_unsized_scenarios_are_ported():
    assert GOLDEN_SCENARIOS == [
        "fig2_adversarial", "fig7_ms_ex", "fig7_systor", "fig8_cdn", "fig8_twitter",
        "real_like_cdn", "real_like_twitter",
    ]
    assert all(os.path.exists(os.path.join(GOLDEN_DIR, f"{n}.json")) for n in GOLDEN_SCENARIOS)


@pytest.mark.parametrize("name", GOLDEN_SCENARIOS)
def test_mini_rows_match_the_golden(minis, name):
    """test_golden.py's comparison, row for row, with its rounding: the
    automata, ARC and OPT(static) exact; OGB and OMD regret within
    max(FLOAT_ATOL * T, 0.5% of it)."""
    res, golden = minis[name], _golden(name)
    assert res.rows.keys() == golden["rows"].keys()
    assert (res.N, res.T, res.C) == (golden["N"], golden["T"], golden["C"])
    assert res.skipped == ()
    for policy, entry in golden["rows"].items():
        got = res.rows[policy]
        for metric, want in entry.items():
            value = round(got[metric], 10 if metric == "hit_ratio" else 6)
            if metric == "hit_ratio":
                if policy in FLOAT_ROWS:
                    continue  # the Poisson p: held below from the reference's carry
                tol = EXACT_ATOL
            else:
                tol = max(FLOAT_ATOL * golden["T"], abs(want) * 5e-3)
            assert value == pytest.approx(want, abs=tol), (name, policy, metric, value, want)


def _reference_carry(kind, n, c, eta):
    """The reference's initial carry leaves, its p from the stream the
    goldens were made with."""
    with jax.threefry_partitionable(False):
        carry = japi.policy_def(kind).init(n, c, seed=0, eta=eta, horizon=None)
        return {k: np.asarray(v) for k, v in carry._asdict().items()}


@pytest.mark.parametrize("kind", ["ogb", "omd"])
@pytest.mark.parametrize("name", GOLDEN_SCENARIOS)
def test_fractional_hit_ratio_from_the_reference_p(name, kind):
    """run_scenario's fractional row, started from the reference's own
    carry: its hit ratio within FLOAT_ATOL of the golden, and its regret
    as above."""
    sc = tscen.get_scenario(name)
    n, t, c = sc.dims("mini")
    trace = sc.make_trace("mini")
    batch = min(sc.batch, max(t // 20, 1))
    pd = repro_torch.policy_def(kind)
    t_used = (len(trace) // batch) * batch
    eta = pd.default_eta(n, c, t_used, batch)
    carry = repro_torch.carry_from_numpy(_reference_carry(kind, n, c, eta), "cpu")
    res = repro_torch.run(pd, trace, capacity=c, window=batch, carry=carry, device="cpu")
    golden = _golden(name)["rows"][pd.name]
    assert res.hit_ratio == pytest.approx(golden["hit_ratio"], abs=FLOAT_ATOL)
    regret = res.opt_hits - float(res.reward.sum())
    tol = max(FLOAT_ATOL * t, abs(golden["regret"]) * 5e-3)
    assert regret == pytest.approx(golden["regret"], abs=tol)


def test_run_scenario_rejects_what_is_not_ported():
    with pytest.raises(KeyError):
        tscen.get_scenario("no_such_scenario")
    with pytest.raises(ValueError):
        tscen.SCENARIOS["fig8_cdn"].dims("huge")


def test_run_scenario_skips_the_host_oracle_past_its_limit(monkeypatch):
    monkeypatch.setattr(tscen, "HOST_POLICY_MAX_T", 100)
    res = tscen.run_scenario("fig2_adversarial", "mini", policies=("lru", "arc"), device="cpu")
    assert res.skipped == ("arc",) and set(res.rows) == {"LRU", "OPT(static)"}


def test_scenario_registry_matches_the_reference():
    from repro.cachesim import scenarios as jscen

    assert tscen.SCENARIOS.keys() == jscen.SCENARIOS.keys()
    for name, sc in tscen.SCENARIOS.items():
        ref = jscen.SCENARIOS[name]
        for scale in ("mini", "quick", "full"):
            assert sc.dims(scale) == ref.dims(scale)
        assert (sc.policies, sc.trace, sc.batch, sc.trace_seed, sc.sized) == (
            ref.policies, ref.trace, ref.batch, ref.trace_seed, ref.sized)
        np.testing.assert_array_equal(sc.make_trace("mini"), ref.make_trace("mini"))
    assert tscen.COMPARISON_POLICIES == jscen.COMPARISON_POLICIES
    assert tscen.HOST_POLICY_MAX_T == jscen.HOST_POLICY_MAX_T
