"""The slice as a whole: repro_torch.run(policy_def("ogb")) against repro's.

Both replay the same zipf trace from the same carry: the JAX package's
initial carry, whose Poisson p comes from JAX's threefry stream, is carried
across with carry_from_numpy.  The port runs on the CPU here, through its
kernels' plain versions.
"""

import numpy as np
import pytest
import torch

from repro.cachesim import api as japi
from repro.cachesim import traces as jtraces
from repro.core.ogb import theoretical_eta as j_theoretical_eta
from repro.core.regret import best_static_hits as j_best_static_hits
import repro_torch
from repro_torch.cachesim import traces as ttraces
from repro_torch.core.ogb import theoretical_eta
from repro_torch.core.regret import best_static_hits

N, C, T, W = 2000, 100, 20_000, 100


@pytest.fixture(scope="module")
def trace():
    return ttraces.zipf(N, T, alpha=0.8, seed=0)


def _jax_run(trace, projection):
    pd = japi.policy_def("ogb", projection=projection)
    carry = pd.init(N, C, seed=0, eta=theoretical_eta(C, N, T, 1), horizon=T)
    leaves = {k: np.asarray(v) for k, v in carry._asdict().items()}
    return japi.run(pd, trace, capacity=C, window=W, carry=carry), leaves


@pytest.mark.parametrize("projection", ["warm", "bisect"])
def test_run_matches_reference_replay(trace, projection):
    want, leaves = _jax_run(trace, projection)
    got = repro_torch.run(
        repro_torch.policy_def("ogb", projection=projection), trace, capacity=C,
        window=W, carry=repro_torch.carry_from_numpy(leaves, "cpu"), device="cpu",
    )
    assert got.T == want.T == T
    np.testing.assert_allclose(got.aux, want.aux, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.reward, want.reward, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.occupancy, want.occupancy, rtol=0, atol=1)
    np.testing.assert_allclose(got.final_f, np.asarray(want.carry.f), rtol=0, atol=1e-5)
    # Poisson hits can flip where f_i ~ p_i under another summation order
    assert abs(int(got.hits.sum()) - int(want.hits.sum())) <= T // 10_000
    assert got.opt_hits == want.opt_hits
    assert int(got.carry.t) == int(np.asarray(want.carry.t)) == T // W


def test_run_defaults_resolve_eta_and_stay_feasible(trace):
    res = repro_torch.run(repro_torch.policy_def("ogb"), trace, N, C, window=W, device="cpu")
    assert res.extras["eta"] == theoretical_eta(C, N, T, 1)
    f = res.final_f
    assert f.min() >= 0.0 and f.max() <= 1.0
    assert abs(float(f.sum(dtype=np.float64)) - C) < 1e-3
    assert 0.0 < res.hit_ratio < 1.0 and res.opt_hits >= res.hits.sum()
    assert np.all(res.aux >= 0.0)


def test_sample_none_counts_no_hits(trace):
    res = repro_torch.run(
        repro_torch.policy_def("ogb", sample="none"), trace, N, C, window=W, device="cpu"
    )
    assert res.hits.sum() == 0
    np.testing.assert_allclose(res.occupancy, C, rtol=0, atol=1e-3)


def test_two_chunked_runs_equal_one_run_bit_for_bit(trace):
    pd = repro_torch.policy_def("ogb")
    full = repro_torch.run(pd, trace, N, C, window=W, device="cpu")
    cut = 70 * W
    first = repro_torch.run(
        pd, trace[:cut], N, C, window=W, horizon=T, eta=full.extras["eta"], device="cpu"
    )
    second = repro_torch.run(pd, trace[cut:], capacity=C, window=W, carry=first.carry,
                             device="cpu")
    for name in ("reward", "hits", "aux", "occupancy"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(first, name), getattr(second, name)]),
            getattr(full, name),
        )
    for a, b in zip(second.carry, full.carry):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [{"eta": 0.1}, {"seed": 3}, {"horizon": 5}])
def test_resume_rejects_init_kwargs(trace, kw):
    pd = repro_torch.policy_def("ogb")
    first = repro_torch.run(pd, trace[: 3 * W], N, C, window=W, device="cpu")
    with pytest.raises(ValueError, match="resumes with the carry"):
        repro_torch.run(pd, trace, carry=first.carry, window=W, device="cpu", **kw)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(trace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.run(repro_torch.policy_def("ogb"), trace, N, C, window=W)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.carry_from_numpy({})


def test_unported_options_and_bad_input_raise(trace):
    with pytest.raises(ValueError, match="madow"):
        repro_torch.policy_def("ogb_tree", sample="madow")
    assert repro_torch.policy_def("ogb_grad").kind == "ogb_grad"
    with pytest.raises(KeyError, match="ported so far"):
        repro_torch.policy_def("no_such_kind")
    with pytest.raises(ValueError, match="trace ids"):
        repro_torch.run(repro_torch.policy_def("ogb"), trace, 100, 10, window=W, device="cpu")


@pytest.mark.parametrize("kind,alpha,seed", [("zipf", 0.8, 4), ("cdn_like", 1.1, 5),
                                             ("zipf", 0.5, 6)])
def test_copied_host_modules_match_the_reference(kind, alpha, seed):
    got = ttraces.make_trace(kind, 500, 3000, seed=seed, alpha=alpha)
    np.testing.assert_array_equal(
        got, jtraces.make_trace(kind, 500, 3000, seed=seed, alpha=alpha)
    )
    for cap in (1, 50, 499, 600):
        assert best_static_hits(got, cap) == j_best_static_hits(got, cap)
    assert theoretical_eta(50, 500, 3000, 4) == j_theoretical_eta(50, 500, 3000, 4)
