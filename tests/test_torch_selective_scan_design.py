"""The card's selective-scan kernel, its order of arithmetic modelled in float32, on the CPU.

``csrc/selective_scan.cu`` pre-scales each channel's row of A once,
a' = A * log2(e) (both float32, the product rounded once), and a step of a
channel, with dx = dt * x rounded once, takes for k = 0 .. n-1

    dec = 0.5 * ex2.approx.ftz(fma(dt, a', 1))
    h_k = fma(dec, h_k, dx * B_k)        the drive's product rounded first
    acc = fma(h_k, C_k, acc)             in k order, the first a product

and y = fma(D, x, acc), in a form that keeps the state scaled by 2^j at a
chunk's j-th step, so that the 1/2 costs nothing (``scaled_model``, bit for
bit the same numbers).  The SFU's argument is 1 + dt a', near 1 where a
decay is near 1, as the accurate ``expf`` reduces dt A in [-ln 2, 0)
(2^(1 + dt a') / 2): ex2.approx of dt a' itself, near 0, drifts the
long-memory channels' state past the gate on the card.  The decode step
(S = 1) is a kernel of its own with the same arithmetic.
``design_model`` below does it in float32: the SFU's result as exp2 of the
rounded argument in float64 rounded once to float32 (results below 2^-126
flushed to zero, as ``.ftz`` does), an fma as one float64 multiply-add
rounded to float32, which is exact in the product.  It is held against the port's plain version
``ref.py::selective_scan_ref`` within 1e-5 of the largest |value| of y and
of the state, the kernel's gate on the card (chip_smoke.py's SCAN_TOL,
tests/test_torch_cuda.py), at slow, served and fast dt (chip_smoke.py's
SCAN_DT), n 8 and 16, from a zero and a mid-run state, over 1, 7 and 2049
steps; and the port's ``mamba_forward`` with its scan swapped for the model
is held against ``repro.models.mamba.mamba_forward``.  Inputs are drawn
with numpy from a seed as chip_smoke.py's ``scan_inputs`` draws them: x, B
and C N(0, 1), dt = softplus(c + s N(0, 1)), A = -(1 .. n) exp(0.3 N(0, 1)),
D = 1 + 0.1 N(0, 1), a mid-run state the plain version's after 256 steps.
"""

import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke as jax_smoke
from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro_torch.configs.base import get_smoke
from repro_torch.kernels.selective_scan import kernel
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.models import mamba, model

SOURCE = (pathlib.Path(kernel.__file__).resolve().parent / "csrc" /
          "selective_scan.cu").read_text()
TOL = 1e-5  # of the largest |value| of y and of the state (chip_smoke.py's SCAN_TOL)
#: dt = softplus(c + s N(0, 1)) for (c, s) (chip_smoke.py's SCAN_DT)
SCAN_DT = {"served": (0.0, 0.6), "slow": (math.log(math.expm1(1e-3)), 0.1), "fast": (5.0, 0.1)}
WARM = 256  # steps of the plain version that make a mid-run state (chip_smoke.py's SCAN_WARM)
LOG2E = np.float32(math.log2(math.e))  # kLog2e in the source
B, D_IN = 2, 64
ARCH = "jamba-1.5-large-398b"


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def design_model(x, dt, A, Bm, Cm, D, state):
    """y (B, S, d_in) and the final state, in the kernel's order of arithmetic
    (numpy float32, the fmas in float64 rounded once)."""
    x, dt, A, Bm, Cm, D, h = (t.numpy() for t in (x, dt, A, Bm, Cm, D, state))
    a2 = A * LOG2E
    ys = []
    for t in range(x.shape[1]):
        dv, xv = dt[:, t], x[:, t]  # (B, d_in)
        dx = dv * xv
        e = np.exp2(_fma(dv[:, :, None], a2, np.float32(1.0)).astype(np.float64))
        e = e.astype(np.float32)
        dec = np.float32(0.5) * np.where(e < 2.0 ** -126, np.float32(0.0), e)
        h = _fma(dec, h, dx[:, :, None] * Bm[:, t, None, :])
        c = Cm[:, t, None, :]
        acc = h[..., 0] * c[..., 0]
        for k in range(1, h.shape[-1]):
            acc = _fma(h[..., k], c[..., k], acc)
        ys.append(_fma(D, xv, acc))
    return torch.from_numpy(np.stack(ys, axis=1)), torch.from_numpy(h)


def _inputs(n, S, dt, mid_run, seed):
    rng = np.random.default_rng(seed)
    c, spread = SCAN_DT[dt]

    def draw(steps):
        x = rng.normal(size=(B, steps, D_IN))
        dts = np.logaddexp(c + spread * rng.normal(size=(B, steps, D_IN)), 0.0)
        Bm, Cm = rng.normal(size=(B, steps, n)), rng.normal(size=(B, steps, n))
        return [torch.from_numpy(a.astype(np.float32)) for a in (x, dts, Bm, Cm)]

    A = torch.from_numpy((-np.arange(1, n + 1) * np.exp(0.3 * rng.normal(size=(D_IN, n))))
                         .astype(np.float32))
    D = torch.from_numpy((1.0 + 0.1 * rng.normal(size=D_IN)).astype(np.float32))
    state = torch.zeros(B, D_IN, n)
    if mid_run:
        x, dts, Bm, Cm = draw(WARM)
        state = selective_scan_ref(x, dts, A, Bm, Cm, D, state)[1]
    x, dts, Bm, Cm = draw(S)
    return x, dts, A, Bm, Cm, D, state


def _within(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("dt", list(SCAN_DT))
@pytest.mark.parametrize("mid_run", [False, True], ids=["zero state", "mid-run state"])
@pytest.mark.parametrize("S", [1, 7, 2049])
@pytest.mark.parametrize("n", [8, 16])
def test_design_order_matches_the_plain_scan(n, S, mid_run, dt):
    inputs = _inputs(n, S, dt, mid_run, seed=n * 10_000 + S)
    y, final = design_model(*inputs)
    assert y.shape == (B, S, D_IN) and final.shape == (B, D_IN, n)
    assert bool(torch.isfinite(y).all() and torch.isfinite(final).all())
    want_y, want_h = selective_scan_ref(*inputs)
    _within(y, want_y)
    _within(final, want_h)


def scaled_model(x, dt, A, Bm, Cm, D, state, chunk):
    """The kernel's own form of the same arithmetic: in each chunk of steps
    the state kept as g = 2^j h at step j, the SFU's result 2 dec taken as
    it is, the drive and y scaled by 2^j and 2^-j, g scaled back at the
    chunk's end (numpy float32)."""
    x, dt, A, Bm, Cm, D, g = (t.numpy() for t in (x, dt, A, Bm, Cm, D, state))
    a2 = A * LOG2E
    ys = []
    for t0 in range(0, x.shape[1], chunk):
        up = down = np.float32(1.0)
        for t in range(t0, min(t0 + chunk, x.shape[1])):
            up, down = up * np.float32(2.0), down * np.float32(0.5)
            dv, xv = dt[:, t], x[:, t]
            dx = (dv * xv) * up
            e = np.exp2(_fma(dv[:, :, None], a2, np.float32(1.0)).astype(np.float64))
            e = np.where(e < 2.0 ** -126, 0.0, e).astype(np.float32)
            g = _fma(e, g, dx[:, :, None] * Bm[:, t, None, :])
            c = Cm[:, t, None, :]
            acc = g[..., 0] * c[..., 0]
            for k in range(1, g.shape[-1]):
                acc = _fma(g[..., k], c[..., k], acc)
            ys.append(_fma(D, xv, acc * down))
        g = g * down
    return torch.from_numpy(np.stack(ys, axis=1)), torch.from_numpy(g)


@pytest.mark.parametrize("dt", list(SCAN_DT))
@pytest.mark.parametrize("S, chunk", [(1, 1), (37, kernel.CHUNK), (37, 5)])
def test_the_scaled_state_is_the_unscaled_arithmetic_bit_for_bit(S, chunk, dt):
    """The kernel keeps the state scaled by 2^j within a chunk (the decode
    step a chunk of one): every scaling is by a power of two, so y and the
    state are the unscaled model's bit for bit."""
    inputs = _inputs(16, S, dt, True, seed=7 + S)
    y, h = scaled_model(*inputs, chunk)
    want_y, want_h = design_model(*inputs)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


@pytest.mark.parametrize("with_state", [False, True], ids=["no state", "state"])
def test_mamba_forward_through_the_design_matches_the_reference(monkeypatch, with_state):
    """The port's Mamba layer with its scan in the kernel's order against
    ``repro``'s, at test_torch_jamba.py's tolerance (1e-5 of the largest
    |value| of y, the convolution state and h)."""
    jcfg, cfg = jax_smoke(ARCH), get_smoke(ARCH)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    params = model.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    p = params["blocks"][0]["mamba"]
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"][0]["mamba"])
    rng = np.random.default_rng(2)
    d_in = cfg.ssm_expand * cfg.d_model
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    state = (rng.normal(size=(2, cfg.ssm_conv_width - 1, d_in)).astype(np.float32),
             rng.normal(size=(2, d_in, cfg.ssm_state_dim)).astype(np.float32))
    calls = []

    def scan(x, dt, A, Bm, Cm, D, h):
        calls.append(x.shape[1])
        y, final = design_model(x, dt, A, Bm, Cm, D, h)
        h.copy_(final)
        return y

    monkeypatch.setattr(mamba, "selective_scan", scan)
    ours = None if not with_state else tuple(torch.from_numpy(a.copy()) for a in state)
    out, (conv, h) = mamba.mamba_forward(p, torch.from_numpy(x), cfg, ours)
    jout, (jconv, jh) = jmamba.mamba_forward(
        jp, jnp.asarray(x), cfg, None if not with_state else tuple(map(jnp.asarray, state)))
    assert calls == [12]
    for got, want in ((out, jout), (conv, jconv), (h, jh)):
        _within(got, want)


def test_the_source_holds_the_wrappers_plan():
    """The plan's constants in the source are kernel.py's, and the ring fits
    the blocks an SM asked for (227 KB an SM, 1 KB a block reserved)."""
    found = {name: int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))
             for name in ("kThreads", "kMinBlocks", "kChunk", "kStages", "kUnroll")}
    assert (found["kMinBlocks"], found["kChunk"], found["kStages"], found["kUnroll"]) == (
        kernel.MIN_BLOCKS, kernel.CHUNK, kernel.STAGES, kernel.UNROLL)
    assert re.search(r"constexpr float kLog2e = ([\d.]+)f;", SOURCE).group(1).startswith(
        "1.44269504")
    for n in kernel.STATE_DIMS:
        slot = kernel.CHUNK * (2 * found["kThreads"] + 2 * n)  # x, dt, then B, C
        assert kernel.MIN_BLOCKS * (4 * kernel.STAGES * slot + 1024) <= 232_448
    assert found["kThreads"] * kernel.MIN_BLOCKS <= 2048  # threads an SM
    assert kernel.STAGES >= 2 and kernel.CHUNK >= 1
    assert "ex2.approx.ftz.f32" in SOURCE and "expf(" not in SOURCE


def test_each_launch_names_its_design():
    assert kernel.design(1) == kernel.DESIGN_STEP
    assert {kernel.design(s) for s in (2, 7, 2048)} == {kernel.DESIGN}
    assert kernel.DESIGN != kernel.DESIGN_STEP
