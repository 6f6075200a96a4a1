"""The histogram's two plans and the warm projection's epilogue, on the CPU.

On a CPU tensor the wrappers run their plain versions, so these tests hold
that arithmetic against ``repro`` (``scatter_counts`` in interpret mode and
its jnp reference, ``capped_simplex_project_warm``), and the plan choices and
constants against the CUDA sources.  Inputs are made with numpy from a seed.
Histograms are integer counts and must be equal exactly; the warm
projection's tau within 1e-6 of the reference and f' within 1e-5, the
tolerances of test_torch_fractional.py::test_warm_newton_matches_reference.
The CUDA kernels themselves are held against the same plain versions on the
card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.projection import capped_simplex_tau, project_capped_simplex
from repro.jaxcache import fractional as jfr
from repro.kernels.scatter_counts.ops import scatter_counts
from repro.kernels.scatter_counts.ref import scatter_counts_ref
from repro_torch.jaxcache import fractional as tfr
from repro_torch.kernels import design_counts, launch_counts
from repro_torch.kernels.capped_simplex import ops as cs_ops
from repro_torch.kernels.capped_simplex.ref import apply_ref, project_warm_ref, project_warm_tau_ref
from repro_torch.kernels.scatter_counts import ops as sc_ops
from repro_torch.kernels.scatter_counts.ref import histogram_ref

KERNELS = pathlib.Path(sc_ops.__file__).resolve().parents[1]


def _constant(source, name):
    text = (KERNELS / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _skewed_ids(b, n, seed, hot=0.95):
    """``b`` int32 bucket ids over [0, n) as a re-anchor makes them: a share
    ``hot`` in one bucket (every item clipped to y = 0), the rest spread,
    and a few out of range on each side."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, size=b)
    ids[rng.random(b) < hot] = rng.integers(0, n)
    ids[rng.integers(0, b, size=max(1, b // 1000))] = -1
    ids[rng.integers(0, b, size=max(1, b // 1000))] = n + rng.integers(0, 50)
    return ids.astype(np.int32)


def test_histogram_at_the_reanchor_shape_equals_the_reference():
    ids = _skewed_ids(1_000_000, 65536, 0)
    got = sc_ops.histogram(torch.from_numpy(ids), 65536).numpy()
    want = np.asarray(scatter_counts_ref(jnp.asarray(ids), 65536))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, histogram_ref(torch.from_numpy(ids), 65536).numpy())
    assert got.max() >= 0.95 * 1_000_000 - 5000
    assert got.sum() == np.count_nonzero((ids >= 0) & (ids < 65536))


@pytest.mark.parametrize("b,n", [(4096, 2048), (3000, 1000), (700, 1000)])
def test_skewed_histogram_equals_the_pallas_kernel(b, n):
    ids = _skewed_ids(b, n, b + n)
    got = sc_ops.histogram(torch.from_numpy(ids), n).numpy()
    pallas = np.asarray(scatter_counts(jnp.asarray(ids), n, interpret=True))
    np.testing.assert_array_equal(got, pallas)


def test_design_picks_bin_tiles_for_the_chunk_and_id_slices_for_a_reanchor():
    assert sc_ops.design(1000, 1_000_000) == sc_ops.BIN_TILES
    assert sc_ops.design(1_000_000, 65536) == sc_ops.ID_SLICES
    assert sc_ops.design(0, 1) == sc_ops.BIN_TILES
    # past one tile of bins, the ids are sliced once they outnumber half the bins
    n = sc_ops.TILE_BINS + 2
    assert sc_ops.design(n // 2, n) == sc_ops.BIN_TILES
    assert sc_ops.design(n // 2 + 1, n) == sc_ops.ID_SLICES
    # bins that fit one tile take one bin-tiles block whatever the ids
    assert sc_ops.design(500, 1000) == sc_ops.BIN_TILES
    assert sc_ops.design(501, 1000) == sc_ops.BIN_TILES


def test_histogram_plan():
    # an H100: 132 SMs; one id-slices block an SM (128 KB of counters)
    chunk = sc_ops.histogram_plan(1000, 1_000_000, 132, 1)
    assert chunk == {"design": "bin tiles", "blocks": 123}  # ceil(1e6 / 8192) tiles
    assert sc_ops.histogram_plan(1, 4, 132, 1) == {"design": "bin tiles", "blocks": 1}
    big = sc_ops.histogram_plan(1000, 10**8, 132, 1)
    assert big["blocks"] == 132 * sc_ops.TILE_BLOCKS_PER_SM  # tiles loop past the grid
    assert sc_ops.histogram_plan(1_000_000, 65536, 132, 1) == {"design": "id slices",
                                                               "blocks": 132}


def test_plan_constants_mirror_the_sources():
    src = "scatter_counts/csrc/histogram.cu"
    assert sc_ops.TILE_THREADS == _constant(src, "kTileThreads")
    assert sc_ops.TILE_BINS == _constant(src, "kTileBins")
    assert sc_ops.SLICE_THREADS == _constant(src, "kSliceThreads")
    assert sc_ops.SLICE_BINS == _constant(src, "kSliceBins")
    assert sc_ops.SLICE_PIECE_IDS == _constant(src, "kPieceIds")
    # a piece of ids never overflows a 16-bit counter, and is whole warps
    assert sc_ops.SLICE_PIECE_IDS < 1 << 16 and sc_ops.SLICE_PIECE_IDS % sc_ops.SLICE_THREADS == 0
    # 4 bin-tiles blocks fill an SM's 2048 threads
    assert sc_ops.TILE_BLOCKS_PER_SM * sc_ops.TILE_THREADS == 2048


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


@pytest.mark.parametrize("sweeps", [0, 1, 5])
@pytest.mark.parametrize("n,b,eta", [(1000, 100, 0.05), (3001, 300, 0.01)])
def test_project_warm_is_the_tau_solve_then_apply_bit_for_bit(n, b, eta, sweeps):
    f, counts, c, eta, y = _step(n, b, n + sweeps, eta)
    hi = float(jfr.warm_bracket_hi(eta * np.float32(b)))
    args = (_t(f), _t(counts), _s(eta), _s(c), _s(0.0), _s(hi),
            _s(1.2 * capped_simplex_tau(y, c)), sweeps)
    got_f, got_tau = cs_ops.project_warm(*args)
    tau = project_warm_tau_ref(*args)
    assert torch.equal(got_tau, tau)
    assert torch.equal(got_tau, cs_ops.project_warm_tau(*args))
    assert torch.equal(got_f, apply_ref(_t(f), _t(counts), _s(eta), tau))
    ref_f, ref_tau = project_warm_ref(*args)
    assert torch.equal(got_f, ref_f) and torch.equal(got_tau, ref_tau)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("n,b,eta", [(2000, 1000, 0.002), (6000, 300, 0.05)])
def test_warm_projection_through_project_warm_matches_the_reference(n, b, eta, seed):
    f, counts, c, eta, y = _step(n, b, seed, eta)
    hi = float(jfr.warm_bracket_hi(eta * np.float32(b)))
    tau0 = 1.2 * capped_simplex_tau(y, c)
    got_f, got_tau = tfr.capped_simplex_project_warm(
        _t(f), _t(counts), float(eta), float(c), 0.0, hi, tau0
    )
    want_f, want_tau = jfr.capped_simplex_project_warm(jnp.asarray(y), float(c), 0.0, hi, tau0)
    assert abs(float(got_tau) - float(want_tau)) <= 1e-6
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0, atol=1e-5)


def test_cpu_calls_count_no_launches():
    before, designs = launch_counts(), design_counts()
    f, counts, c, eta, _y = _step(500, 50, 0, 0.05)
    ids = torch.from_numpy(_skewed_ids(2000, 500, 1))
    sc_ops.histogram(ids, 500)
    cs_ops.project_warm(_t(f), _t(counts), float(eta), float(c), 0.0, 3.0, 0.1, 5)
    cs_ops.apply(_t(f), _t(counts), float(eta), 0.1)
    assert launch_counts() == before
    assert design_counts() == designs


def test_design_counts_sum_a_kernels_wrappers():
    saved = {fn: (fn.launches, dict(fn.designs))
             for fn in (cs_ops.project_warm_tau, cs_ops.project_warm, cs_ops.apply)}
    try:
        for fn in saved:
            fn.launches, fn.designs = 0, {}
        cs_ops.project_warm_tau.launches = 2
        cs_ops.project_warm_tau.designs = {"persistent, y in registers": 2}
        cs_ops.project_warm.launches = 3
        cs_ops.project_warm.designs = {"persistent, y in registers": 3}
        cs_ops.apply.launches = 4
        cs_ops.apply.designs = {cs_ops.EPILOGUE: 3, cs_ops.STANDALONE: 1}
        designs = design_counts()
        assert designs["mass"]["persistent, y in registers"] == 5
        assert designs["apply"] == {"projection epilogue": 3, "standalone": 1}
        assert launch_counts()["apply"] == 4
    finally:
        for fn, (launches, by_design) in saved.items():
            fn.launches, fn.designs = launches, by_design


def test_other_devices_raise():
    f = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cs_ops.project_warm(f, f, 0.1, 2.0, 0.0, 1.0, 0.5, 5)
    with pytest.raises(ValueError, match="CUDA"):
        sc_ops.histogram(torch.zeros(2_000, dtype=torch.int32, device="meta"), 1000)
