"""`ClientCache`: a per-client hot-key cache validated by version stamps.

Port of ``repro.cache.client``.  The cache itself (its per-key
`OrderedDict` of ``bytes``, the TinyLFU sketch, the valve) lives on the
host, in client memory, as in the reference; the backends call the port's
stores and cluster on their device and hand back the reference's numpy
arrays (uint32 values, int64 stamps of uint32 words, object name arrays).

The paper's lookups are one-sided — the server never sees a read, so it
can never invalidate a client cache.  Continuity hashing makes that a
feature instead of a bug: every committed mutation on a bucket pair
rewrites ONE 8-byte word (indicator bits + the per-pair op counter in its
upper half, `core.continuity.ContinuityTable.version`), so a client that
cached ``(value, stamp)`` at fill time can later prove freshness with a
single 8-byte READ: stamp unchanged => no mutation committed on the pair
since the fill => the cached value IS what a full lookup would return.
Invalidation is log-free and protocol-free; its entire cost is one verb.

Correctness contract (the property the tests drive): a validating read
NEVER serves a value a committed mutation has replaced.  Three rules
enforce it, each mapped to a counter:

  * stamps are compared row-wise and exactly; any mismatch evicts
    (``stamp_invalidations``);
  * a stamp is only comparable against the endpoint that produced it
    (replica histories diverge across resync); an answer from a
    different node evicts too (``source_invalidations``), and an
    UNRESOLVED validation (partition, migration window, delivery
    timeout) is never served — the entry survives, unservable, until a
    future validation proves or disproves it
    (``unresolved_validations``);
  * shed reads (the `Backpressure` valve) are refused outright — a shed
    op is never quietly served from cache.

Within one round a validated/filled entry is served without re-checking:
reads of round t begin after round t's writes committed, so serving the
value fetched this round is a legal linearization.  ``trust_window > 0``
extends that trust across rounds — cheaper, but a mutation committing
inside the window CAN then be missed, which is why the gated zero-stale
runs use ``trust_window=0`` (validate on every cross-round hit).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.cache.policy import Backpressure, FrequencySketch, key_hash
from repro_torch.core.pmem import CostLedger
from repro_torch.core.words import u32
from repro_torch.rdma import verbs as rv

U32 = np.uint32


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Knobs for one client's cache (all seeded / deterministic)."""

    capacity: int = 128          # resident entries
    trust_window: int = 0        # rounds a validation is trusted for
    #                              (0 = validate every cross-round hit: the
    #                              zero-stale configuration the CI gates)
    sketch_width: int = 1024     # TinyLFU count-min width (power of two)
    sketch_depth: int = 4
    sketch_sample: Optional[int] = None   # halve counters every N adds
    admission: bool = True       # False = plain LRU fill (no TinyLFU)
    budget: Optional[int] = None          # per-round backend-fetch valve
    seed: int = 0


@dataclasses.dataclass
class _Entry:
    value: np.ndarray            # (4,) uint32
    stamp: np.ndarray            # (S,) int64 — endpoint version stamp
    source: str                  # the node that produced the stamp
    validated_round: int


class RoundResult(NamedTuple):
    """One client round of reads through the cache."""

    values: np.ndarray           # (B, 4) uint32 (zeros where not served)
    found: np.ndarray            # (B,) bool — served with a live value
    served: np.ndarray           # (B,) bool — False only for shed ops
    hit: np.ndarray              # (B,) bool — served from cache
    op_us: np.ndarray            # (B,) simulated wire latency (0 = local)


class ClientCache:
    """One client's cache in front of a `CacheBackend`.

    ``read_round(keys)`` is the unit of work: the round's reads are
    deduplicated, cached keys are validated in ONE batch, misses are
    fetched in ONE batch (after the admission sketch and the backpressure
    valve see them) — the request-coalescing that collapses per-node
    doorbells in the fan-in sim.  Writes don't pass through the cache;
    call ``invalidate(keys)`` for the client's own writes (remote writers
    need nothing: their commits bump the version word the next validation
    reads).
    """

    def __init__(self, config: CacheConfig, backend: Any):
        self.config = config
        self.backend = backend
        self.entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self.sketch = FrequencySketch(config.sketch_width,
                                      config.sketch_depth,
                                      config.sketch_sample, config.seed)
        self.valve = Backpressure(config.budget)
        self.round = 0
        self.stats = {
            "rounds": 0, "ops": 0, "hits": 0, "trusted_hits": 0,
            "misses": 0, "fills": 0, "validations": 0,
            "stamp_invalidations": 0, "source_invalidations": 0,
            "unresolved_validations": 0,
            "shed": 0, "admit_rejects": 0, "evictions": 0,
        }

    # -- internals ----------------------------------------------------------
    def _touch(self, kb: bytes) -> None:
        self.entries.move_to_end(kb)

    def _admit(self, kb: bytes, entry: _Entry) -> None:
        cfg = self.config
        if kb in self.entries:
            self.entries[kb] = entry
            self._touch(kb)
            return
        if len(self.entries) < cfg.capacity:
            self.entries[kb] = entry
            self.stats["fills"] += 1
            return
        victim = next(iter(self.entries))
        if cfg.admission and (self.sketch.estimate(key_hash(kb))
                              <= self.sketch.estimate(key_hash(victim))):
            # TinyLFU: a one-hit wonder may not displace a hotter resident
            self.stats["admit_rejects"] += 1
            return
        del self.entries[victim]
        self.stats["evictions"] += 1
        self.entries[kb] = entry
        self.stats["fills"] += 1

    def invalidate(self, keys) -> int:
        """Drop entries for the client's OWN writes (write-through)."""
        keys = np.asarray(keys, U32).reshape(-1, 4)
        n = 0
        for k in keys:
            n += self.entries.pop(k.tobytes(), None) is not None
        return n

    # -- the round ----------------------------------------------------------
    def read_round(self, keys) -> RoundResult:
        cfg = self.config
        self.round += 1
        keys = np.asarray(keys, U32).reshape(-1, 4)
        B = keys.shape[0]
        self.stats["rounds"] += 1
        self.stats["ops"] += B

        kb = [k.tobytes() for k in keys]
        uniq: "OrderedDict[bytes, int]" = OrderedDict()
        for b in kb:
            if b not in uniq:
                uniq[b] = len(uniq)
        ukeys = np.frombuffer(b"".join(uniq), U32).reshape(-1, 4)
        for b in uniq:                       # request frequency, hits included
            self.sketch.add(key_hash(b))

        u_val = np.zeros((len(uniq), 4), U32)    # per-uniq served value
        u_fnd = np.zeros(len(uniq), bool)
        u_hit = np.zeros(len(uniq), bool)
        u_srv = np.ones(len(uniq), bool)
        u_us = np.zeros(len(uniq))

        need_check, need_fetch = [], []
        for b, i in uniq.items():
            e = self.entries.get(b)
            if e is None:
                need_fetch.append(i)
            elif self.round - e.validated_round <= cfg.trust_window:
                u_val[i], u_fnd[i], u_hit[i] = e.value, True, True
                self.stats["hits"] += 1
                self.stats["trusted_hits"] += 1
                self._touch(b)
            else:
                need_check.append(i)

        if need_check:
            idx = np.array(need_check)
            stamps, source, resolved, op_us = self.backend.validate(
                ukeys[idx])
            self.stats["validations"] += len(idx)
            for j, i in enumerate(idx):
                b = ukeys[i].tobytes()
                e = self.entries[b]
                ok = bool(resolved[j]) and str(source[j]) == e.source \
                    and np.array_equal(stamps[j], e.stamp)
                u_us[i] = op_us[j]
                if ok:
                    e.validated_round = self.round
                    u_val[i], u_fnd[i], u_hit[i] = e.value, True, True
                    self.stats["hits"] += 1
                    self._touch(b)
                elif bool(resolved[j]):
                    # disproven: a committed mutation moved the pair's
                    # version word, or the keyspace re-routed the key to a
                    # different answerer whose history the stamp cannot
                    # vouch against — evict
                    del self.entries[b]
                    if str(source[j]) == e.source:
                        self.stats["stamp_invalidations"] += 1
                    else:
                        self.stats["source_invalidations"] += 1
                    need_fetch.append(i)
                else:
                    # nobody COULD answer (partition, migration window,
                    # delivery timeout): the entry is not disproven, just
                    # unservable this round — keep it (it is only ever
                    # served after a future successful validation) and
                    # fall back to a backend fetch for this op
                    self.stats["unresolved_validations"] += 1
                    need_fetch.append(i)

        if need_fetch:
            idx = np.array(sorted(need_fetch))
            freqs = np.array([self.sketch.estimate(key_hash(ukeys[i].tobytes()))
                              for i in idx])
            grant = self.valve.grant(freqs)
            self.stats["shed"] += int((~grant).sum())
            u_srv[idx[~grant]] = False
            idx = idx[grant]
            if len(idx):
                self.stats["misses"] += len(idx)
                values, found, stamps, source, op_us = self.backend.fetch(
                    ukeys[idx])
                for j, i in enumerate(idx):
                    u_val[i], u_fnd[i], u_us[i] = values[j], found[j], op_us[j]
                    ok_stamp = bool(found[j]) and str(source[j]) != "" \
                        and not (np.asarray(stamps[j]) < 0).any()
                    if ok_stamp:
                        self._admit(ukeys[i].tobytes(),
                                    _Entry(np.array(values[j], U32),
                                           np.array(stamps[j], np.int64),
                                           str(source[j]), self.round))

        inv = np.array([uniq[b] for b in kb])
        return RoundResult(u_val[inv], u_fnd[inv], u_srv[inv], u_hit[inv],
                           u_us[inv])

    def hit_rate(self) -> float:
        tot = self.stats["hits"] + self.stats["misses"] + self.stats["shed"]
        return self.stats["hits"] / tot if tot else 0.0


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

def _host_stamps(st: torch.Tensor) -> np.ndarray:
    """Device stamp words -> the reference's int64 rows of uint32 values."""
    return u32(st).cpu().numpy()


class StoreBackend:
    """Single-store backend: a `repro_torch.api` store + table (on the
    store's device), priced through `ledger_from_plan` (and an optional
    `RemoteMemory` endpoint).  Whoever mutates the store updates
    ``.table``: the port's write ops update the table in place and return
    it, so the property tests' harness assigns it back as the reference's
    does.  The accumulated `CostLedger` prices validation READs and miss
    lookups honestly from their verb plans."""

    def __init__(self, store, table, mem=None, name: str = "local"):
        self.store = store
        self.table = table
        self.mem = mem
        self.name = name
        self.ledger = CostLedger.zero(store.device)

    def validate(self, keys):
        keys = np.asarray(keys, U32).reshape(-1, 4)
        stamps = _host_stamps(self.store.version_stamp(self.table, keys))
        plan = self.store.version_read_plan(self.table, keys)
        self.ledger = self.ledger.merge(rv.ledger_from_plan(plan))
        op_us = np.zeros(keys.shape[0])
        if self.mem is not None:
            comp = self.mem.post(plan, tag="validate")
            op_us = comp.op_us
        return (stamps, np.full(keys.shape[0], self.name, object),
                np.ones(keys.shape[0], bool), op_us)

    def fetch(self, keys):
        keys = np.asarray(keys, U32).reshape(-1, 4)
        res = self.store.lookup(self.table, keys)
        stamps = _host_stamps(self.store.version_stamp(self.table, keys))
        self.ledger = self.ledger.merge(rv.ledger_from_plan(res.plan))
        op_us = np.zeros(keys.shape[0])
        if self.mem is not None:
            comp = self.mem.post(res.plan, tag="fill")
            op_us = comp.op_us
        return (res.values.cpu().numpy().view(U32), res.ok.cpu().numpy(),
                stamps, np.full(keys.shape[0], self.name, object), op_us)


class ClusterBackend:
    """`ClusterStore` backend: validations are `version_read` rounds
    (tagged 8-byte READs to each key's serving member), fetches are
    `lookup_stamped` rounds; both inherit the cluster's fencing rules, so
    partitioned/lagging/migrating answers surface as unresolved and the
    cache degrades to misses instead of trusting anything stale."""

    def __init__(self, cluster):
        self.cluster = cluster
        # (kind, touched-node-set, round_us) per backend call since the
        # caller last cleared it — the fan-in sim's per-node queue model
        # reads this to charge each round's wire time to the nodes it hit
        self.last: list = []

    def validate(self, keys):
        r = self.cluster.version_read(keys)
        self.last.append(("validate",
                          {str(s) for s in r.source if str(s)},
                          float(r.round_us)))
        return r.stamps, r.source, r.resolved, r.op_us

    def fetch(self, keys):
        r = self.cluster.lookup_stamped(keys)
        self.last.append(("fetch",
                          {str(s) for s in r.source if str(s)},
                          float(r.round_us)))
        return r.values, r.found, r.stamps, r.source, r.op_us
