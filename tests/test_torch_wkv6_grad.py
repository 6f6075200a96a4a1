"""The WKV-6 recurrence's gradient against the JAX package, on the CPU.

``kernels/wkv6/ref.py``'s ``wkv6_bwd_ref`` (the plain version of the
backward kernel ``csrc/wkv6_bwd.cu``) is held against ``torch.autograd`` of
the plain forward ``wkv6_ref`` and against ``jax.grad`` of ``repro``'s
``_wkv_scan`` (its ``lax.scan``), at every head dim the kernel takes, a
ragged S, slow decay (rwkv6's w0 = -6, w ~ 0.9975) and fast decay (w ~
1e-3), from a zero and a nonzero start state: dr, dk, dv, dw and du each
within 1e-5 of its largest (float32 sums in another order).  ``WKV6``, the
autograd function that ``wkv6`` becomes under autograd, runs those plain
versions on the CPU, launches nothing, leaves the start state as it was, and
raises on a start state that requires grad and on a gradient into the final
state.  On the card chip_smoke.py phase 29 and the ``cuda`` tests hold the
kernel against the same plain version.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.rwkv import _wkv_scan
from repro_torch.kernels import launch_counts
from repro_torch.kernels.wkv6.ops import WKV6, wkv6, wkv6_bwd
from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref, wkv6_ref

GRAD_TOL = 1e-5  # of each gradient's largest |value|
#: w0 of w = exp(-exp(w0 + 0.12 N(0, 1))): rwkv6's initial -6 (w ~ 0.9975), and
#: w ~ 1e-3
DECAYS = {"slow": -6.0, "fast": math.log(-math.log(1e-3))}
#: (n, S, decay, start state): every head dim, S of one step, one chunk, one
#: past it and ragged
CASES = [(16, 1, "slow", "zero"), (16, 19, "fast", "nonzero"), (32, 16, "slow", "nonzero"),
         (32, 33, "fast", "zero"), (64, 17, "slow", "zero"), (64, 37, "slow", "nonzero"),
         (64, 15, "fast", "nonzero")]
B, H = 2, 2


def _inputs(n, S, decay, state, seed):
    """r, k, v, dy N(0, 1), w from ``decay``, u 0.1 N(0, 1), the start state
    zero or N(0, 1), float32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.normal(size=(B, S, H, n)).astype(np.float32) for _ in range(4))
    w = np.exp(-np.exp(DECAYS[decay] + 0.12 * rng.normal(size=(B, S, H, n)))).astype(np.float32)
    u = (0.1 * rng.normal(size=(H, n))).astype(np.float32)
    s0 = (rng.normal(size=(B, H, n, n)) if state == "nonzero"
          else np.zeros((B, H, n, n))).astype(np.float32)
    return r, k, v, w, u, s0, dy


def _close(got, want, tol=GRAD_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("n,S,decay,state", CASES,
                         ids=[f"n{n}-S{S}-{d}-{s}" for n, S, d, s in CASES])
def test_backward_plain_version_matches_autograd_and_jax(n, S, decay, state):
    arrays = _inputs(n, S, decay, state, seed=n * 100 + S)
    r, k, v, w, u, s0, dy = map(torch.from_numpy, arrays)
    got = wkv6_bwd_ref(r, k, v, w, u, s0, dy)
    assert all(g.dtype == torch.float32 for g in got)

    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    y, _ = wkv6_ref(*leaves, s0)
    y.backward(dy)
    for g, leaf in zip(got, leaves):  # at S = 1 no y reads w: autograd leaves its grad None
        auto = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        _close(g.numpy(), auto.numpy())

    rn, kn, vn, wn, un, s0n, dyn = arrays

    def loss(r, k, v, w, u):
        return jnp.sum(_wkv_scan(r, k, v, w, u, s0n)[0] * dyn)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(rn, kn, vn, wn, un)
    for g, ref in zip(got, want):
        _close(g.numpy(), ref)


def test_function_runs_the_plain_versions_on_the_cpu():
    r, k, v, w, u, s0, dy = map(torch.from_numpy, _inputs(32, 21, "slow", "nonzero", seed=5))
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    state = s0.clone()
    before = launch_counts()
    y, final = wkv6(*leaves, state)
    assert type(y.grad_fn).__name__ == "WKV6Backward" and issubclass(WKV6, torch.autograd.Function)
    want_y, want_final = wkv6_ref(r, k, v, w, u, s0)
    assert y.detach().equal(want_y) and final.equal(want_final)
    assert state.equal(s0)  # under autograd the start state is not written
    y.backward(dy)
    assert launch_counts() == before
    for leaf, want in zip(leaves, wkv6_bwd(r, k, v, w, u, s0, dy)):
        assert leaf.grad.equal(want)
    with torch.no_grad():  # the serving call: the final state written in place
        y2, same = wkv6(r, k, v, w, u, state)
    assert same is state and state.equal(want_final) and y2.equal(want_y)


def test_function_raises_on_a_start_state_that_requires_grad():
    r, k, v, w, u, s0, _ = map(torch.from_numpy, _inputs(16, 5, "fast", "zero", seed=6))
    with pytest.raises(RuntimeError, match="start state"):
        wkv6(r.requires_grad_(True), k, v, w, u, s0.requires_grad_(True))


def test_function_raises_on_a_gradient_into_the_final_state():
    r, k, v, w, u, s0, dy = map(torch.from_numpy, _inputs(16, 5, "slow", "zero", seed=7))
    y, final = wkv6(r.requires_grad_(True), k, v, w, u, s0)
    with pytest.raises(RuntimeError, match="final state"):
        ((y * dy).sum() + final.sum()).backward()
