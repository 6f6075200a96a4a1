"""The per-row forms of the fleet's kernels, through their plain versions.

A fleet steps every tenant in one launch a chunk, each tenant over its own
row of ids (``(E, W)`` ids), where a sweep's grid shares one ``(W,)`` chunk.
On the CPU each wrapper runs its plain version (``ref.py``) row by row; here
every row of each (histogram, the warm solve over a counts row a row,
``tree_lru``, ``minpair_automaton`` in its LFU, FTPL and GDS modes,
``fifo_queue``, and the int32 tree build of a grid's rings) must equal the
one-row call on the same row, bit for bit, carries included, and the
shapes a row form takes are checked.  The card's
cases are in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.cachesim import engines as te
from repro_torch.cachesim import tree_engines as tt
from repro_torch.cachesim.traces import zipf
from repro_torch.jaxcache.fractional import warm_bracket_hi
from repro_torch.kernels.capped_simplex.ops import project_warm, project_warm_tau
from repro_torch.kernels.scatter_counts.ops import BIN_TILES, histogram, histogram_plan

N, W, E = 300, 200, 4
CAPS = (10, 25, 40, 17)


@pytest.fixture(scope="module")
def ids():
    rows = [zipf(N, 3 * W, alpha=0.9, seed=e) for e in range(E)]
    return torch.from_numpy(np.stack(rows).astype(np.int32))  # (E, 3W): three chunks a row


def _copy(carry):
    return type(carry)(*(x.clone() if isinstance(x, torch.Tensor) else x for x in carry))


def _equal(a, b):
    ta = [x for x in a if isinstance(x, torch.Tensor)]
    tb = [x for x in b if isinstance(x, torch.Tensor)]
    return len(ta) == len(tb) > 0 and all(torch.equal(x, y) for x, y in zip(ta, tb))


def test_histogram_rows(ids):
    got = histogram(ids, N)
    assert got.shape == (E, N)
    for r in range(E):
        assert torch.equal(got[r], histogram(ids[r], N))
    assert torch.equal(histogram(ids[:0], N), torch.zeros((0, N)))
    # a fleet's rows always take bin tiles, whatever the one-row plan
    assert histogram_plan(10**6, 65536, 132, 1, rows=3)["design"] == BIN_TILES
    assert histogram_plan(10**6, 65536, 132, 1)["design"] != BIN_TILES
    with pytest.raises(ValueError):
        histogram(ids[None], N)


def test_warm_solve_over_a_counts_row_a_row(ids):
    gen = torch.Generator().manual_seed(1)
    caps = torch.tensor([float(c) for c in CAPS])
    f = torch.rand((E, N), generator=gen) * (2.0 * caps[:, None] / N)
    counts = histogram(ids[:, :W].contiguous(), N)
    eta = 0.02 + 0.05 * torch.rand(E, generator=gen)
    hi = warm_bracket_hi(eta * float(W))
    tau0 = hi * torch.rand(E, generator=gen)
    lo = torch.zeros(E)
    got_f, got_tau = project_warm(f, counts, eta, caps, lo, hi, tau0, 5)
    assert torch.equal(project_warm_tau(f, counts, eta, caps, lo, hi, tau0, 5), got_tau)
    for r in range(E):
        one_f, one_tau = project_warm(f[r], counts[r], eta[r], caps[r], lo[r], hi[r], tau0[r], 5)
        assert torch.equal(one_f, got_f[r]) and torch.equal(one_tau, got_tau[r])
    # a shared (N,) histogram is the sweep's form, each row over it
    shared_f, _ = project_warm(f, counts[0], eta, caps, lo, hi, tau0, 5)
    one_f, _ = project_warm(f[1], counts[0], eta[1], caps[1], lo[1], hi[1], tau0[1], 5)
    assert torch.equal(shared_f[1], one_f)
    with pytest.raises(ValueError):
        project_warm(f, counts[:2], eta, caps, lo, hi, tau0, 5)


def _chunks(ids):
    return [ids[:, k * W:(k + 1) * W].contiguous() for k in range(3)]


@pytest.mark.parametrize("kind", ["lru", "lfu", "ftpl"])
def test_tree_automata_rows(ids, kind):
    carries = [tt.init_tree_engine_carry(kind, N, c, n_slots=max(CAPS), seed=r, horizon=10**4,
                                         device="cpu") for r, c in enumerate(CAPS)]
    grid = tt.grid_start([_copy(c) for c in carries])
    ones = [tt.start_tree_run(c) for c in carries]
    for chunk in _chunks(ids):
        flags = torch.empty((E, W), dtype=torch.bool)
        if kind == "lru":
            grid, (hits, stats) = tt.grid_lru_chunk(grid, chunk, flags)
        else:
            grid, (hits, stats) = tt.tree_chunk(kind, grid, chunk, flags)
        assert hits.shape == (E,) and stats.shape == (E, 3)
        for r in range(E):
            one_flags = torch.empty(W, dtype=torch.bool)
            ones[r], (h, st) = tt.tree_chunk(kind, ones[r], chunk[r], one_flags)
            assert int(h) == int(hits[r]) and torch.equal(st, stats[r])
            assert torch.equal(one_flags, flags[r])
    for r, row in enumerate(tt.grid_split(grid)):
        assert _equal(row, ones[r])
    with pytest.raises(ValueError):
        tt.tree_chunk(kind, grid, ids[:2, :W].contiguous()) if kind != "lru" else \
            tt.grid_lru_chunk(grid, ids[:2, :W].contiguous())


def test_gds_rows(ids):
    rng = np.random.default_rng(2)
    sizes = rng.choice([1.0, 4.0, 16.0], size=N)
    carries = [tt.init_tree_gds_carry(N, c, max(CAPS), sizes=sizes, device="cpu") for c in CAPS]
    grid = type(carries[0])(*(torch.stack(x) for x in zip(*carries)))
    ones = [_copy(c) for c in carries]
    for chunk in _chunks(ids):
        flags = torch.empty((E, W), dtype=torch.bool)
        grid, (hits, stats) = tt.tree_chunk("gds", grid, chunk, flags)
        for r in range(E):
            one_flags = torch.empty(W, dtype=torch.bool)
            ones[r], (h, st) = tt.tree_chunk("gds", ones[r], chunk[r], one_flags)
            assert int(h) == int(hits[r]) and torch.equal(st, stats[r])
            assert torch.equal(one_flags, flags[r])
    for r in range(E):
        assert _equal(type(grid)(*(x[r] for x in grid)), ones[r])


def test_fifo_rows(ids):
    carries = [te.init_engine_carry("fifo", N, c, n_slots=max(CAPS), device="cpu") for c in CAPS]
    grid = te.start_fifo_grid(carries, N)
    ones = [te.start_fifo_run(c, N) for c in carries]
    for chunk in _chunks(ids):
        flags = torch.empty((E, W), dtype=torch.bool)
        grid, (hits, stats) = te.fifo_grid_chunk(grid, chunk, flags)
        for r in range(E):
            one_flags = torch.empty(W, dtype=torch.bool)
            ones[r], (h, st) = te.fifo_chunk(ones[r], chunk[r], one_flags)
            assert int(h) == int(hits[r]) and torch.equal(st, stats[r])
            assert torch.equal(one_flags, flags[r])
    for r, row in enumerate(te.split_fifo_grid(grid)):
        assert _equal(row, te.finish_fifo_run(ones[r]))
    with pytest.raises(ValueError):
        te.fifo_grid_chunk(grid, ids[:2, :W].contiguous())


@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_int32_tree_builds_of_a_grid(n):
    """R int32 trees of one shape into rows 16 bytes apart: each row the
    one-tree build of its leaves."""
    from repro_torch.kernels.prefix_tree.ops import tree_build, tree_build_rows_
    from repro_torch.kernels.prefix_tree.ref import tree_storage

    gen = torch.Generator().manual_seed(n)
    leaves = torch.randint(0, 9, (E, n + 2), generator=gen, dtype=torch.int32)[:, :n]
    tot = tree_storage(n, 16)
    out = torch.zeros((E, (tot + 3) & ~3), dtype=torch.int32)[:, :tot]
    assert tree_build_rows_(leaves, 16, out) is out
    for r in range(E):
        assert torch.equal(out[r], tree_build(leaves[r].contiguous(), 16))
    with pytest.raises(ValueError):
        tree_build_rows_(leaves, 16, out[:, :-1])
