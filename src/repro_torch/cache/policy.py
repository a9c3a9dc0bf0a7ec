"""Admission + backpressure policies for the client hot-key cache.

Port of ``repro.cache.policy``, kept bit-exact: host numpy with uint64
wraparound, the same salts from ``RandomState(seed)``, the same halving
decay and the same stable tie order.  It stays on the host on purpose: a
client's cache lives in client memory, not in the store's tables.

Under a zipf hotspot a naive cache churns: every cold key that passes
through evicts something hot, and the hot set never stabilizes.  TinyLFU
(Einziger et al.) fixes that with a tiny frequency sketch consulted at
admission time — a candidate only displaces the eviction victim if it has
been REQUESTED more often — so one-hit wonders bounce off and the resident
set converges to the true hot set.  The sketch is a count-min with
periodic halving (aging), so yesterday's hot keys decay instead of
squatting forever.

`Backpressure` is the shedding valve: a per-round budget of backend
fetches per client.  When a hotspot storm floods a client with more cold
misses than the budget, the COLDEST misses (by sketch estimate) are shed —
refused, never served stale — which caps the per-node fan-in while the
hot keys (cache hits + the hottest misses) keep flowing.  Everything is
seeded and deterministic.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

U64 = np.uint64

# splitmix64-style avalanche constants: spread 16-byte keys into 64-bit
# hashes whose low bits are well-mixed for the per-row slots
_MIX = U64(0x9E3779B97F4A7C15)
_AV1, _AV2 = U64(0xBF58476D1CE4E5B9), U64(0x94D049BB133111EB)


def key_hash(key_bytes: bytes) -> int:
    """Deterministic 64-bit hash of a key's raw bytes (no PYTHONHASHSEED)."""
    with np.errstate(over="ignore"):
        h = U64(int.from_bytes(key_bytes[:8], "little")) * _MIX
        h ^= U64(int.from_bytes(key_bytes[8:16].ljust(8, b"\0"), "little"))
        h = (h ^ (h >> U64(30))) * _AV1
        h = (h ^ (h >> U64(27))) * _AV2
    return int(h ^ (h >> U64(31)))


class FrequencySketch:
    """Count-min sketch with halving decay — TinyLFU's frequency oracle.

    ``depth`` salted rows of ``width`` 8-bit counters; an estimate is the
    row minimum.  After ``sample`` total increments every counter halves
    (aging), so estimates track the RECENT request distribution and the
    admission filter adapts when the hot set drifts.
    """

    def __init__(self, width: int = 1024, depth: int = 4,
                 sample: Optional[int] = None, seed: int = 0):
        assert width > 0 and width & (width - 1) == 0, "width: power of two"
        self.width = width
        self.depth = depth
        self.rows = np.zeros((depth, width), np.uint8)
        rng = np.random.RandomState(seed)
        self.salts = rng.randint(1, 2 ** 62, size=depth).astype(U64) | U64(1)
        self.sample = sample if sample is not None else 8 * width
        self.adds = 0
        self.ages = 0

    def _slots(self, h: int) -> np.ndarray:
        with np.errstate(over="ignore"):
            mixed = (U64(h) * self.salts) >> U64(17)
        return (mixed & U64(self.width - 1)).astype(np.int64)

    def add(self, h: int) -> None:
        s = self._slots(h)
        cur = self.rows[np.arange(self.depth), s]
        self.rows[np.arange(self.depth), s] = np.minimum(
            cur.astype(np.int64) + 1, 255).astype(np.uint8)
        self.adds += 1
        if self.adds >= self.sample:
            self.rows >>= 1          # halving decay: recency over history
            self.adds = 0
            self.ages += 1

    def estimate(self, h: int) -> int:
        return int(self.rows[np.arange(self.depth), self._slots(h)].min())


class Backpressure:
    """Per-round backend-fetch budget: the hotspot shedding valve.

    ``budget=None`` disables the valve (every miss fetches).  Otherwise at
    most ``budget`` backend fetches are granted per round; the caller
    offers misses with their sketch frequencies and the valve keeps the
    hottest ``budget`` of them.  Shed ops are REFUSED — counted, reported
    to the caller, and never served from a stale entry.
    """

    def __init__(self, budget: Optional[int] = None):
        assert budget is None or budget >= 0
        self.budget = budget
        self.shed = 0
        self.granted = 0

    def grant(self, freqs: np.ndarray) -> np.ndarray:
        """(n,) bool: which of the offered misses may fetch this round.
        ``freqs[i]`` is the i-th miss's sketch estimate; ties keep the
        earlier offer (stable ordering keeps runs deterministic)."""
        n = len(freqs)
        if self.budget is None or n <= self.budget:
            self.granted += n
            return np.ones(n, bool)
        keep = np.argsort(-np.asarray(freqs), kind="stable")[: self.budget]
        out = np.zeros(n, bool)
        out[keep] = True
        self.granted += int(self.budget)
        self.shed += n - int(self.budget)
        return out
