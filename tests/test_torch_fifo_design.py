"""The FIFO queue's design on the CPU: admission tickets and the kernel's tile.

``kernels/fifo_queue`` keeps each item's admission ticket, the number of
the run's miss that admitted it, in place of an item -> slot map: after M
misses an item is held iff ``M - A <= ticket`` (A the active slots).  Here

* that rule, from a queue derived at the start and from one derived
  mid-run, gives the reference's dense FIFO's hit request by request
  (``repro.cachesim.engines._fifo_step`` scanned one request at a time);
* a numpy emulation of ``csrc/fifo_queue.cu`` (the tile plan from 32 active
  slots: a tile of up to 256 requests resolved at once, the requests an
  eviction of the tile may reach settled in order; the chain plan below it)
  gives the plain version's hits, flags and every leaf of the carry and the
  queue, chunk by chunk, on traces whose tiles evict an item and request
  it again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cachesim import engines as jeng
from repro_torch.cachesim import engines as teng
from repro_torch.kernels.fifo_queue.ops import TILE_MIN_SLOTS, tile_requests
from repro_torch.kernels.fifo_queue.ref import derive_queue, fifo_queue_ref


def _reference_flags(carry, ids):
    """The reference's dense FIFO over ``ids``: its carry and each hit."""
    carry, hits = jax.lax.scan(jeng._fifo_step, carry, jnp.asarray(ids, jnp.int32))
    return carry, np.asarray(hits)


def _churn(n, c, length, seed):
    """C distinct ids (admitted in order), then requests that keep the
    queue's oldest items in play: new ids, ids admitted about C misses ago
    (at the queue's head, or just evicted) and repeats of the last few."""
    rng = np.random.default_rng(seed)
    out, nxt = list(range(c)), c
    for _ in range(length):
        u = rng.random()
        if u < 0.4:
            out.append(nxt % n)
            nxt += 1
        elif u < 0.75:
            out.append(int(rng.integers(max(0, nxt - c - 40), max(1, nxt - c + 40))) % n)
        else:
            out.append(out[-1 - int(rng.integers(0, 8))])
    return np.asarray(out, np.int64)


def _ticket_hits(queue, ids):
    """The ticket rule alone, request by request (the queue's tensors
    untouched): each request's hit."""
    a = queue.order.numel()
    tickets = queue.imap.numpy().astype(np.int64).copy()
    m = int(queue.misses)
    flags = np.zeros(len(ids), bool)
    for r, j in enumerate(ids.tolist()):
        if m <= tickets[j] + a:
            flags[r] = True
        else:
            tickets[j] = m
            m += 1
    return flags


@pytest.mark.parametrize("c,n_slots", [(25, None), (31, 40), (32, None), (64, None),
                                       (1000, None), (1000, 1100)])
def test_ticket_rule_gives_the_reference_hits(c, n_slots):
    n = 4 * c + 400
    trace = _churn(n, c, 6 * c + 600, c)
    cut = len(trace) // 2
    start = jeng.init_engine_carry("fifo", n, c, n_slots=n_slots)
    mid, first = _reference_flags(start, trace[:cut])
    _, second = _reference_flags(mid, trace[cut:])
    want = np.concatenate([first, second])
    assert 0 < want.sum() < len(want)
    # from the empty carry: one queue for the whole trace
    slots, stamps = (torch.from_numpy(np.array(x)) for x in start[:2])
    np.testing.assert_array_equal(_ticket_hits(derive_queue(slots, stamps, n), trace), want)
    # from the reference's mid-run carry: held items ticketed by position
    slots, stamps = (torch.from_numpy(np.array(x)) for x in mid[:2])
    queue = derive_queue(slots, stamps, n)
    assert int(queue.occ) == c
    np.testing.assert_array_equal(_ticket_hits(queue, trace[cut:]), second)


# -- a numpy emulation of csrc/fifo_queue.cu -----------------------------------

class _Card:
    """The kernel's state, as numpy arrays, and what its tiles met."""

    def __init__(self, carry):
        q = carry.queue
        self.slots, self.stamps = carry.slots.numpy().copy(), carry.stamps.numpy().copy()
        self.t = int(carry.t)
        self.order, self.imap = q.order.numpy().copy(), q.imap.numpy().copy()
        self.head, self.occ, self.misses = int(q.head), int(q.occ), int(q.misses)
        self.seen = {"unsure hit": 0, "unsure miss": 0, "repeat": 0}

    def leaves(self):
        return (self.slots, self.stamps, self.t, self.order, self.head, self.imap, self.occ,
                self.misses)

    def chunk(self, ids):
        a, t0, m_start = len(self.order), self.t, self.misses
        m0, hits = m_start, 0
        flags = np.zeros(len(ids), bool)
        size = tile_requests(a) if a >= TILE_MIN_SLOTS else 32
        for base in range(0, len(ids), size):
            tile = ids[base:base + size]
            missed = (self._tile if a >= TILE_MIN_SLOTS else self._chain)(tile, m0, base, t0)
            flags[base:base + len(tile)] = ~missed
            m = int(missed.sum())
            hits += len(tile) - m
            m0 += m
            self.head = (self.head + m) % a
        misses = m0 - m_start
        self.occ = a if misses >= a - self.occ else self.occ + misses
        self.misses, self.t = m0, t0 + len(ids)
        return hits, flags

    def _write(self, j, g, rank, base, lane, t0, victims):
        self.imap[j] = g
        self.slots[victims[rank]] = j
        self.stamps[victims[rank]] = t0 + base + lane

    def _tile(self, tile, m0, base, t0):
        """The tile plan: every request at once, then the unsure ones in order."""
        a, n, size = len(self.order), len(tile), tile_requests(len(self.order))
        ticket = self.imap[tile].astype(np.int64)  # one gather at the tile's start
        victims = self.order[(self.head + np.arange(size)) % a]
        low = m0 - a
        held = ticket >= low
        life = np.where(held, ticket - low, -1)
        first = np.zeros(n, bool)
        first[np.unique(tile, return_index=True)[1]] = True
        miss = ~held & first
        unsure = held & (life < size - 1)
        left = life.copy()
        for q in np.flatnonzero(unsure):
            k = int(miss[:q].sum())
            peers = tile == tile[q]
            if k > left[q]:
                miss[q] = True
                left[peers] = k + a
                self.seen["unsure miss"] += 1
            else:
                self.seen["unsure hit"] += 1
        self.seen["repeat"] += int((~first).sum())
        rank = np.cumsum(miss) - miss
        for q in np.flatnonzero(miss):
            self._write(tile[q], m0 + rank[q], rank[q], base, q, t0, victims)
        return miss

    def _chain(self, tile, m0, base, t0):
        """The chain plan: the requests in order, tickets kept current."""
        a = len(self.order)
        ticket = self.imap[tile].astype(np.int64)
        victims = self.order[(self.head + np.arange(32)) % a]
        miss = np.zeros(len(tile), bool)
        m = m0
        for q, jq in enumerate(tile):
            if m - a <= ticket[q]:
                continue
            self._write(jq, m, m - m0, base, q, t0, victims)
            ticket[tile == jq] = m
            miss[q] = True
            m += 1
        return miss


@pytest.mark.parametrize("c", [25, 31, 32, 64, 1000, 5000, 20000])
def test_tile_emulation_matches_the_plain_version(c):
    n = 4 * c + 400
    trace = _churn(n, c, min(8 * c + 2000, 60_000), 100 + c).astype(np.int32)
    carry = teng.start_fifo_run(teng.init_engine_carry("fifo", n, c, device="cpu"), n)
    card = _Card(carry)
    rng = np.random.default_rng(c)
    at, evicted_then_hit = 0, 0
    while at < len(trace):
        size = int(rng.integers(1, 300))  # ragged tiles at the chunk's end
        ids = torch.from_numpy(trace[at:at + size])
        at += size
        held_before = set(carry.slots.tolist())
        flags = torch.empty(ids.shape, dtype=torch.bool)
        hits, stats = fifo_queue_ref(carry.slots, carry.stamps, carry.t, carry.queue, ids, flags)
        got_hits, got_flags = card.chunk(ids.numpy())
        assert got_hits == int(hits) and float(stats[2]) == card.occ
        np.testing.assert_array_equal(got_flags, flags.numpy())
        want = (carry.slots, carry.stamps, int(carry.t), carry.queue.order, int(carry.queue.head),
                carry.queue.imap, int(carry.queue.occ), int(carry.queue.misses))
        for name, g, w in zip(("slots", "stamps", "t", "order", "head", "imap", "occ", "misses"),
                              card.leaves(), want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)
        # an item held before the chunk, missed in it and then hit again
        for q, j in enumerate(ids.tolist()):
            if j in held_before and not flags[q] and bool(flags[q + 1:][ids[q + 1:] == j].any()):
                evicted_then_hit += 1
    assert evicted_then_hit > 0
    if c >= TILE_MIN_SLOTS:
        seen = card.seen
        assert seen["unsure hit"] > 0 and seen["unsure miss"] > 0 and seen["repeat"] > 0, seen


@pytest.mark.parametrize("hit", [False, True], ids=["evicted", "outlives"])
@pytest.mark.parametrize("c", [32, 6000, 40000])
def test_tile_settles_the_last_request_at_the_edge_of_its_life(c, hit):
    """C slots filled in order by one chunk, then a tile of S - 1 new ids
    (S = tile_requests(C)) and one request of item S - 2 (life S - 2: the
    tile's last miss evicts it first) or of item S - 1 (life S - 1: it
    outlives the tile)."""
    size = tile_requests(c)
    n = c + size
    item = size - 1 if hit else size - 2
    carry = teng.start_fifo_run(teng.init_engine_carry("fifo", n, c, device="cpu"), n)
    card = _Card(carry)
    for ids in (np.arange(c), np.concatenate([c + np.arange(size - 1), [item]])):
        ids = torch.from_numpy(ids.astype(np.int32))
        flags = torch.empty(ids.shape, dtype=torch.bool)
        hits, _ = fifo_queue_ref(carry.slots, carry.stamps, carry.t, carry.queue, ids, flags)
        got_hits, got_flags = card.chunk(ids.numpy())
        assert got_hits == int(hits)
        np.testing.assert_array_equal(got_flags, flags.numpy())
    assert bool(flags[-1]) == hit
    np.testing.assert_array_equal(card.imap, carry.queue.imap.numpy())
    np.testing.assert_array_equal(card.slots, carry.slots.numpy())
    assert card.seen == {"unsure hit": 0, "unsure miss": int(not hit), "repeat": 0}
