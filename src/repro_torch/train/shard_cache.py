"""OGB-scored dataset-shard cache: ``repro.train.shard_cache`` over the port's OGB.

Training fleets stream dataset shards from object storage; local NVMe holds
a fraction.  Catalog = dataset shards; a "request" = a pipeline step
touching a shard; the residency policy decides which shards stay local.
This wraps the exact O(log N) OGB policy, :class:`repro_torch.core.ogb.OGB`
(a host-side control plane, as in the reference; no kernel), so the
pipeline calls ``touch(shard_id)`` a shard read and consults
``is_local``/``stats``.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.ogb import OGB


@dataclass
class ShardCacheStats:
    touches: int = 0
    local_hits: int = 0
    fetches: int = 0

    @property
    def local_ratio(self) -> float:
        return self.local_hits / max(self.touches, 1)


class OGBShardCache:
    def __init__(
        self,
        n_shards: int,
        local_capacity: int,
        horizon_touches: int = 100_000,
        batch_size: int = 16,
        seed: int = 0,
    ):
        self.policy = OGB(
            n_shards,
            local_capacity,
            horizon=horizon_touches,
            batch_size=batch_size,
            seed=seed,
        )
        self.stats = ShardCacheStats()

    def is_local(self, shard_id: int) -> bool:
        return self.policy.contains(shard_id)

    def touch(self, shard_id: int) -> bool:
        """Record a shard read; returns True if it was served locally."""
        hit = self.policy.request(shard_id)
        self.stats.touches += 1
        self.stats.local_hits += int(hit)
        self.stats.fetches += int(not hit)
        return hit
