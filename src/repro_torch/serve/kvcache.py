"""Prefix-page KV cache with pluggable residency policy.

A copy of ``repro.serve.kvcache`` (pure Python) for the port's serving
engine.

The serving engine splits every prompt into pages of ``page_size`` tokens;
a page is identified by the hash of the *entire prefix* up to its end (so a
page hit implies the whole prefix matches — the vLLM prefix-caching
invariant).  The page pool holds ``pool_pages`` pages of KV in fast memory;
the residency policy decides admission/eviction.

Policies: the paper's OGB (regret-optimal, O(log N) per touch — the point of
this framework), plus LRU / LFU / FTPL for comparison.  The policy sees one
"request" per page *touch*, batched per engine step: exactly the paper's
batched integral-caching setting.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Sequence



def page_keys(tokens: Sequence[int], page_size: int) -> List[bytes]:
    """Prefix hashes at page granularity (full pages only)."""
    out = []
    h = hashlib.blake2b(digest_size=16)
    n_full = len(tokens) // page_size
    for p in range(n_full):
        chunk = bytes(
            int(t) % 256 for t in tokens[p * page_size : (p + 1) * page_size]
        ) + str(
            list(tokens[p * page_size : (p + 1) * page_size])
        ).encode()
        h.update(chunk)
        out.append(h.digest())
    return out


@dataclass
class PagePoolStats:
    touches: int = 0
    hits: int = 0
    tokens_total: int = 0
    tokens_reused: int = 0
    admissions: int = 0
    evictions: int = 0

    @property
    def page_hit_ratio(self) -> float:
        return self.hits / max(self.touches, 1)

    @property
    def token_reuse_ratio(self) -> float:
        return self.tokens_reused / max(self.tokens_total, 1)


class PagedKVPool:
    """Page pool + id mapping; residency decided by the wrapped policy."""

    def __init__(
        self,
        policy,  # OGB / LRU / ... over integer ids
        page_size: int = 64,
        catalog_size: int = 1 << 20,
    ):
        self.policy = policy
        self.page_size = page_size
        self.catalog_size = catalog_size
        self._ids: Dict[bytes, int] = {}
        self._next_id = 0
        self.stats = PagePoolStats()

    def _page_id(self, key: bytes) -> int:
        pid = self._ids.get(key)
        if pid is None:
            pid = self._next_id % self.catalog_size
            self._next_id += 1
            self._ids[key] = pid
        return pid

    def match_prefix(self, tokens: Sequence[int]) -> int:
        """Longest resident prefix (in tokens) without touching the policy."""
        n = 0
        for key in page_keys(tokens, self.page_size):
            pid = self._ids.get(key)
            if pid is None or not self.policy.contains(pid):
                break
            n += self.page_size
        return n

    def serve(self, tokens: Sequence[int]) -> int:
        """Process one prompt's pages; returns reused token count."""
        keys = page_keys(tokens, self.page_size)
        reused = 0
        still_prefix = True
        for key in keys:
            pid = self._page_id(key)
            hit = self.policy.request(pid)
            self.stats.touches += 1
            self.stats.hits += int(hit)
            if still_prefix and hit:
                reused += self.page_size
            else:
                still_prefix = False
        self.stats.tokens_total += len(tokens)
        self.stats.tokens_reused += reused
        return reused

    def batch_end(self) -> None:
        self.policy.batch_end()

    def occupancy(self) -> float:
        return float(self.policy.occupancy())
