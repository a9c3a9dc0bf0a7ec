"""Client-side hot-key caching for the remote hash table.

Port of ``repro.cache``.  The paper's reads are one-sided (the server
never sees them), so servers cannot invalidate client caches.  This
package turns continuity hashing's commit discipline into the
invalidation protocol instead: every committed mutation rewrites ONE
8-byte word per bucket pair (indicator bits + the per-pair version
counter), so a cached entry is revalidated by a single 8-byte READ of that
word — log-free, protocol-free, one verb.

  `policy`   TinyLFU admission sketch + backpressure shedding valve
  `client`   `ClientCache` (per-client cache + round protocol, on the
             host) and its backends (`StoreBackend` single store,
             `ClusterBackend` over `cluster.ClusterStore`), which run on
             the store's device
  `fanin`    the 100-client fan-in simulation: hotspot storm through
             independent caches with membership chaos underneath,
             cached vs uncached per-node doorbells and p99
"""

from repro_torch.cache.client import (CacheConfig, ClientCache,
                                      ClusterBackend, RoundResult,
                                      StoreBackend)
from repro_torch.cache.policy import Backpressure, FrequencySketch, key_hash

__all__ = [
    "Backpressure", "CacheConfig", "ClientCache", "ClusterBackend",
    "FrequencySketch", "RoundResult", "StoreBackend", "key_hash",
]
