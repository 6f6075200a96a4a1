"""The card's WKV-6 kernel, its order of arithmetic modelled in float32, on the CPU.

``csrc/wkv6.cu`` factors the u term out of the recurrence,

    y_j = sum_i r_i S_ij + v_j ru_t,    ru_t = sum_i r_i u_i k_i,

and cuts each column's n rows into P blocks (``kernel.PLANS``): a thread
sums r_i S_ij over its block's rows in order by fmas from zero, the P
partial sums are added in the order p = 0 .. P-1, ru_t is each float4
piece's 4 terms in order (the first a product, then fmas) followed by a
pairwise tree over the pieces (the kernel's xor shuffles), and
y_j = fma(v_j, ru_t, sum).  The state update is S <- fma(w_i, S, k_i v_j)
with the product rounded first.  C, the columns a thread holds, and the
chunk length change which thread does the work, not the order of any sum.

``design_model`` below does the same arithmetic in float32 (an fma as one
float64 multiply-add rounded to float32, which is exact in the product)
and is held against ``repro.models.rwkv._wkv_scan`` and against the port's
plain version ``ref.py::wkv6_ref`` within 1e-5 of the largest |value| of y
and of the state, the kernel's gate on the card (chip_smoke.py phase 26,
tests/test_torch_cuda.py).  Inputs are drawn with numpy from a seed: r, k,
v N(0, 1), u 0.1 N(0, 1), w = exp(-exp(w0 + 0.12 N(0, 1))) at four decays.
"""

import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as jrwkv
from repro_torch.kernels.wkv6 import kernel
from repro_torch.kernels.wkv6.ref import wkv6_ref

SOURCE = (pathlib.Path(kernel.__file__).resolve().parent / "csrc" / "wkv6.cu").read_text()
TOL = 1e-5  # of the largest |value| of y and of the state (chip_smoke.py's WKV_TOL)
#: w0 of each decay: ~0.9975 (rwkv6's w0), ~0.5, exp(-e^2) ~ 6e-4, ~1 - 6e-6
DECAYS = {"slow": -6.0, "fast": math.log(math.log(2.0)), "near zero": 2.0, "near one": -12.0}
WARM = 32  # steps of the plain version that make a mid-run state
B, H = 2, 2
_scan = jax.jit(jrwkv._wkv_scan)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def design_model(r, k, v, w, u, state, P):
    """y (B, S, H, n) and the final state, in the kernel's order of arithmetic."""
    _, S, _, n = r.shape
    rows = n // P
    s = state.clone()
    ys = []
    for t in range(S):
        rt, kt, vt, wt = (x[:, t] for x in (r, k, v, w))  # (B, H, n)
        parts = []
        for p in range(P):
            acc = torch.zeros_like(vt)
            for i in range(p * rows, (p + 1) * rows):
                acc = _fma(rt[..., i, None], s[..., i, :], acc)
            parts.append(acc)
        total = parts[0]
        for x in parts[1:]:
            total = total + x
        ruk = (rt * u).unflatten(-1, (n // 4, 4))
        kq = kt.unflatten(-1, (n // 4, 4))
        ru = ruk[..., 0] * kq[..., 0]
        for e in range(1, 4):
            ru = _fma(ruk[..., e], kq[..., e], ru)
        while ru.shape[-1] > 1:
            ru = ru[..., 0::2] + ru[..., 1::2]
        ys.append(_fma(vt, ru, total))
        s = _fma(wt[..., :, None], s, kt[..., :, None] * vt[..., None, :])
    return torch.stack(ys, dim=1), s


def _inputs(n, S, decay, mid_run, seed):
    rng = np.random.default_rng(seed)

    def draw(steps):
        r, k, v = (rng.normal(size=(B, steps, H, n)).astype(np.float32) for _ in range(3))
        w = np.exp(-np.exp(DECAYS[decay] + 0.12 * rng.normal(size=(B, steps, H, n))))
        return [torch.from_numpy(x) for x in (r, k, v, w.astype(np.float32))]

    u = torch.from_numpy((0.1 * rng.normal(size=(H, n))).astype(np.float32))
    state = torch.zeros(B, H, n, n)
    if mid_run:
        state = wkv6_ref(*draw(WARM), u, state)[1]
    return (*draw(S), u, state)


def _within(got, want):
    want = torch.from_numpy(np.array(want))
    err = float((got - want).abs().max())
    assert err <= TOL * float(want.abs().max()), (err, float(want.abs().max()))


@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("mid_run", [False, True], ids=["zero state", "mid-run state"])
@pytest.mark.parametrize("S", [1, 7, 33])
@pytest.mark.parametrize("n", [16, 32, 64])
def test_design_order_matches_the_reference_scan(n, S, mid_run, decay):
    inputs = _inputs(n, S, decay, mid_run, seed=n * 100 + S)
    P, _ = kernel.PLANS[n]
    y, final = design_model(*inputs, P)
    assert y.shape == (B, S, H, n) and final.shape == (B, H, n, n)
    assert bool(torch.isfinite(y).all() and torch.isfinite(final).all())
    jy, jfinal = _scan(*(jnp.asarray(x.numpy()) for x in inputs))
    py, pfinal = wkv6_ref(*inputs)
    for got, want in ((y, jy), (final, jfinal), (y, py), (final, pfinal)):
        _within(got, want)


def test_the_source_holds_the_wrappers_plans():
    plans = {int(n): (int(p), int(c)) for n, p, c in re.findall(
        r"struct Plan<(\d+)> \{ static constexpr int kRowBlocks = (\d+), kCols = (\d+); \};",
        SOURCE)}
    assert plans == kernel.PLANS and sorted(plans) == list(kernel.HEAD_DIMS)
    assert int(re.search(r"constexpr int kChunk = (\d+);", SOURCE).group(1)) == kernel.CHUNK
    assert int(re.search(r"constexpr int kStages = (\d+);", SOURCE).group(1)) == kernel.STAGES


@pytest.mark.parametrize("n", [16, 32, 64])
def test_each_plan_keeps_the_kernels_limits(n):
    """The source's static_asserts, and two blocks an SM: whole float4 row
    loads, whole warps, a step's y pieces in whole lanes, and the ring, the
    partials and u in shared memory."""
    P, C = kernel.PLANS[n]
    threads = P * n // C
    assert n % P == 0 and (n // P) % 4 == 0 and C in (1, 2, 4)
    assert threads % 32 == 0 and n <= threads <= 1024 and (kernel.CHUNK * n // 4) % 32 == 0
    smem = 4 * (kernel.STAGES * 4 * kernel.CHUNK * n + kernel.CHUNK * P * n + n)
    assert 2 * (smem + 1024) <= 233_472  # the H100's shared memory an SM, 1 KB a block reserved
    if n == 64:  # the served plan: 32 state registers a thread, 2 warps a scheduler
        assert threads == 128 and (n // P) * C == 32


def test_chip_smoke_counts_the_wrappers_design():
    """chip_smoke.py phase 26 holds rwkv6's launches by design to its own
    copy of the design's name: the wrapper's."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.DESIGNS["wkv6"] == kernel.DESIGN
    assert {case[4] for case in smoke.WKV_CASES} == set(kernel.PLANS)
