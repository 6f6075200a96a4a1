"""FIFO at any capacity: repro_torch's FIFO queue against repro's dense FIFO.

The port runs FIFO on a queue a run derives once from the carry
(:mod:`repro_torch.kernels.fifo_queue`); its plain version is what the
``fifo_queue`` kernel runs on the CPU.  Here it is held against the
reference's dense step (``repro.cachesim.engines.make_engine_fn("fifo")``,
a compare and an argmin over every slot) from the same carry: hits,
occupancy and the carry's slots, stamps and clock bit for bit, past the slot
kernel's 16 384 slots, with padded slots and through resumed runs; and the
queue's byte accounting.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cachesim import engines as jeng
import repro_torch
import repro_torch.core.policies
from repro_torch.cachesim import engines as teng
from repro_torch.cachesim import traces as ttraces
from repro_torch.kernels.fifo_queue.ref import TICKET_NONE, derive_queue, fifo_queue_ref
from repro_torch.kernels.slot_automaton.ops import MAX_SLOTS


def _leaves(carry):
    return {k: np.asarray(v) for k, v in carry._asdict().items()}


def _trace(n, c, seed):
    """C distinct ids (the slots fill), zipf over the catalog, then a round
    robin: every request of the round robin past C misses and evicts."""
    return np.concatenate([ttraces.adversarial(n, c, seed=seed + 1),
                           ttraces.zipf(n, 6 * c // 5 + 500, alpha=0.9, seed=seed),
                           ttraces.adversarial(n, c // 2 + 500, seed=seed)]).astype(np.int64)


@pytest.mark.parametrize("c,n_slots,window", [(20_000, None, 5000), (16_385, 16_400, 4000),
                                              (25, None, 100), (31, 40, 100)])
def test_fifo_matches_reference_dense_fifo(c, n_slots, window):
    n = max(4 * c, 400)
    trace = _trace(n, c, c)
    trace = trace[: len(trace) // window * window]
    jc = jeng.init_engine_carry("fifo", n, c, n_slots=n_slots)
    want, ys = jeng.make_engine_fn("fifo")(jc, jnp.asarray(trace.reshape(-1, window), jnp.int32))
    got = repro_torch.run(repro_torch.policy_def("fifo"), trace, n, c, window=window,
                          n_slots=n_slots, device="cpu")
    assert isinstance(got.carry, teng.SlotCarry)
    np.testing.assert_array_equal(got.hits, np.asarray(ys[0]))
    np.testing.assert_array_equal(got.occupancy, np.asarray(ys[1]))
    for name, value in _leaves(want).items():
        np.testing.assert_array_equal(getattr(got.carry, name).numpy(), value, err_msg=name)
    assert int(got.hits.sum()) < len(trace) - c  # it evicted
    assert c <= MAX_SLOTS or got.carry.slots.numel() > MAX_SLOTS


def test_fifo_resumes_bit_for_bit_past_the_slot_kernel():
    n, c, w = 80_000, 20_000, 5000
    trace = _trace(n, c, 3)
    trace = trace[: len(trace) // w * w]
    pd = repro_torch.policy_def("fifo")
    whole = repro_torch.run(pd, trace, n, c, window=w, device="cpu")
    cut = (len(trace) // w // 2) * w
    first = repro_torch.run(pd, trace[:cut], n, c, window=w, device="cpu")
    kept = [x.clone() for x in first.carry]
    second = repro_torch.run(pd, trace[cut:], capacity=c, window=w, carry=first.carry,
                             device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(first.carry, kept))  # not modified
    np.testing.assert_array_equal(np.concatenate([first.hits, second.hits]), whole.hits)
    assert all(torch.equal(a, b) for a, b in zip(second.carry, whole.carry))


def test_queue_order_is_the_reference_victim_order():
    """From a carry with empty, held and padded slots, the derived order is
    the slots by (stamp, index) without the padding, and the victims of a
    round robin of new items take it in turn."""
    slots = torch.tensor([-1, 7, 3, -1, 9, -2, -2], dtype=torch.int32)
    stamps = torch.tensor([-1, 5, 2, -1, 5, 2**31 - 1, 2**31 - 1], dtype=torch.int32)
    q = derive_queue(slots, stamps, 12)
    assert q.order.tolist() == [0, 3, 2, 1, 4] and int(q.head) == 0 and int(q.occ) == 3
    # admission tickets: position p of the order less the 5 active slots
    none = TICKET_NONE
    assert q.imap.tolist()[:10] == [none, none, none, -3, none, none, none, -2, none, -1]
    t = torch.tensor(6, dtype=torch.int32)
    flags = torch.empty(6, dtype=torch.bool)
    hits, stats = fifo_queue_ref(slots, stamps, t, q, torch.tensor([3, 10, 11, 1, 2, 4],
                                                                   dtype=torch.int32), flags)
    assert flags.tolist() == [True, False, False, False, False, False] and int(hits) == 1
    assert slots.tolist() == [10, 2, 1, 11, 4, -2, -2]
    assert stamps.tolist()[:5] == [7, 10, 9, 8, 11] and int(t) == 12
    assert int(q.head) == 0 and int(q.occ) == 5 and float(stats[2]) == 5.0


def test_sized_fifo_byte_hits_match_its_hits():
    n, c, w = 300, 20, 500
    trace = ttraces.zipf(n, 4000, alpha=0.9, seed=9)
    sizes = np.asarray([1.0, 4.0, 16.0, 64.0])[np.random.default_rng(1).integers(0, 4, n)]
    pd = repro_torch.policy_def("fifo")
    plain = repro_torch.run(pd, trace, n, c, window=w, device="cpu")
    sized = repro_torch.run(pd, trace, n, c, window=w, sizes=sizes, device="cpu")
    np.testing.assert_array_equal(plain.hits, sized.hits)
    assert isinstance(sized.carry, repro_torch.cachesim.api.SizedAutomatonCarry)
    host = repro_torch.core.policies.FIFO(n, c)
    for k in range(len(trace) // w):
        chunk = trace[k * w:(k + 1) * w]
        flags = np.asarray([host.request(int(i)) for i in chunk])
        assert sized.byte_hits[k] == float(np.sum(sizes[chunk][flags]))
    assert sized.bytes_total == float(np.sum(sizes[trace]))


def test_fifo_needs_an_id_bound():
    carry = teng.init_engine_carry("fifo", 10, 3, device="cpu")
    with pytest.raises(ValueError, match="id_bound"):
        teng.start_fifo_run(carry)
