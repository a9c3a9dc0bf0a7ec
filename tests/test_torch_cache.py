"""The port's client cache (`repro_torch.cache`) against the JAX package's,
on the CPU.

The intent of ``tests/test_cache.py``, each case driven through both
packages on the same seeded keys and compared field for field:

  * the policy units — `key_hash`, the TinyLFU sketch (counts, salts,
    over-estimates only, halving decay) and `Backpressure` (unlimited,
    hottest kept, stable ties) — byte-equal on seeded streams;
  * `ClientCache` semantics against a scriptable backend (miss -> fill ->
    validated hit, same-round dedup, stamp mismatch, source flip,
    unresolved-never-served, delete ghost, shed, TinyLFU admission,
    own-write invalidate), every `RoundResult` field, every `stats`
    counter and every resident entry compared;
  * `ClientCache` over `StoreBackend` for all four schemes (the port's
    store on the CPU against the reference's store): the same intents,
    updates and deletes never served stale, plus the store's ledger and a
    `RemoteMemory` endpoint's counters; the ABA stamp and the single
    8-byte validation plan;
  * `ClusterBackend` through partition -> stale write -> heal -> resync,
    the tagged wire accounting, and ``test_tiny_fanin_full_chaos_schedule``'s
    fan-in cell, payload equal to the reference's.
"""

import json

import numpy as np
import pytest

from repro import api as japi
from repro import cache as jcache
from repro.cache import fanin as jfanin
from repro.cluster import ClusterStore as JCluster
from repro.rdma.transport import RemoteMemory as JMem
from repro_torch import api as tapi
from repro_torch import cache as tcache
from repro_torch.cache import fanin as tfanin
from repro_torch.cluster import ClusterStore as TCluster
from repro_torch.data import ycsb
from repro_torch.rdma.transport import RemoteMemory as TMem
from test_torch_cluster import assert_same

U32 = np.uint32
REF = dict(api=japi, cache=jcache, mem=JMem, cluster=JCluster, kw={})
PORT = dict(api=tapi, cache=tcache, mem=TMem, cluster=TCluster,
            kw=dict(device="cpu"))


def K(ids):
    return ycsb.make_key(np.asarray(ids))


def both(fn, *args, **kw):
    return fn(REF, *args, **kw), fn(PORT, *args, **kw)


def round_result(r) -> dict:
    return {f: np.asarray(v) for f, v in zip(r._fields, r)}


def entries(cache) -> list:
    return [(kb, np.asarray(e.value), np.asarray(e.stamp), e.source,
             e.validated_round) for kb, e in cache.entries.items()]


def cache_state(cache) -> dict:
    return {"stats": dict(cache.stats), "round": cache.round,
            "entries": entries(cache), "rows": cache.sketch.rows.copy(),
            "salts": cache.sketch.salts.copy(), "adds": cache.sketch.adds,
            "ages": cache.sketch.ages, "shed": cache.valve.shed,
            "granted": cache.valve.granted}


# ---------------------------------------------------------------------------
# policy units, byte-equal on seeded streams
# ---------------------------------------------------------------------------

def _key_bytes(n, seed):
    rng = np.random.RandomState(seed)
    out = [k.tobytes() for k in K(np.arange(n))]
    out += [rng.bytes(16) for _ in range(n)]
    out += [rng.bytes(int(m)) for m in rng.randint(0, 24, size=n)]
    return out


def test_key_hash_equals_reference_and_spreads():
    kbs = _key_bytes(512, 0)
    hs = [tcache.key_hash(k) for k in kbs]
    assert hs == [jcache.key_hash(k) for k in kbs]
    assert len(set(hs[:1024])) == 1024


@pytest.mark.parametrize("width,depth,sample,seed", [
    (1024, 4, None, 0), (256, 4, None, 1), (64, 2, 32, 0), (128, 3, 100, 7)])
def test_sketch_equals_reference_on_a_seeded_stream(width, depth, sample,
                                                     seed):
    rng = np.random.RandomState(seed + 11)
    stream = [tcache.key_hash(k) for k in _key_bytes(64, seed)]
    draws = rng.zipf(1.3, size=3000) % len(stream)
    port = tcache.FrequencySketch(width, depth, sample, seed)
    ref = jcache.FrequencySketch(width, depth, sample, seed)
    assert np.array_equal(port.salts, ref.salts)
    for i, d in enumerate(draws):
        port.add(stream[d])
        ref.add(stream[d])
        if i % 250 == 0:
            assert [port.estimate(h) for h in stream] == \
                [ref.estimate(h) for h in stream]
    assert np.array_equal(port.rows, ref.rows)
    assert (port.adds, port.ages) == (ref.adds, ref.ages)
    if sample is not None:
        assert port.ages > 0


def test_sketch_counts_overestimates_only_and_decays():
    sk = tcache.FrequencySketch(width=256, depth=4, seed=1)
    h, other = tcache.key_hash(b"a" * 16), tcache.key_hash(b"b" * 16)
    for _ in range(5):
        sk.add(h)
    assert sk.estimate(h) >= 5              # count-min never undercounts
    assert sk.estimate(other) <= sk.estimate(h)
    sk = tcache.FrequencySketch(width=64, depth=2, sample=32, seed=0)
    h = tcache.key_hash(b"hot!" * 4)
    for _ in range(20):
        sk.add(h)
    before = sk.estimate(h)
    for i in range(40):                     # push past the sample boundary
        sk.add(tcache.key_hash(i.to_bytes(8, "little")))
    assert sk.ages >= 1
    assert sk.estimate(h) <= before // 2 + 1


@pytest.mark.parametrize("budget", [None, 0, 1, 2, 5])
def test_backpressure_equals_reference(budget):
    rng = np.random.RandomState(3)
    port, ref = tcache.Backpressure(budget), jcache.Backpressure(budget)
    for n in (0, 1, 3, 4, 8, 17):
        freqs = rng.randint(0, 4, size=n)    # many ties
        assert np.array_equal(port.grant(freqs), ref.grant(freqs))
        assert (port.shed, port.granted) == (ref.shed, ref.granted)
    assert tcache.Backpressure(2).grant(np.array([5, 1, 9, 1])).tolist() \
        == [True, False, True, False]
    assert tcache.Backpressure(1).grant(np.array([3, 3, 3])).tolist() \
        == [True, False, False]


# ---------------------------------------------------------------------------
# ClientCache semantics against a scriptable backend
# ---------------------------------------------------------------------------

class FakeBackend:
    """Dict-served backend with switches for source flips and
    unresolved (partition-style) validations (``tests/test_cache.py``'s)."""

    def __init__(self):
        self.data = {}                      # kb -> (value, stamp int)
        self.source = "n0"
        self.resolved = True
        self.fetches = 0

    def put(self, i, val, stamp):
        self.data[K([i])[0].tobytes()] = (np.asarray(val, U32), stamp)

    def drop(self, i):
        self.data.pop(K([i])[0].tobytes(), None)

    def validate(self, keys):
        keys = np.asarray(keys, U32).reshape(-1, 4)
        B = keys.shape[0]
        stamps = np.full((B, 1), -1, np.int64)
        for j, k in enumerate(keys):
            if k.tobytes() in self.data:
                stamps[j, 0] = self.data[k.tobytes()][1]
        return (stamps, np.full(B, self.source, object),
                np.full(B, self.resolved, bool), np.zeros(B))

    def fetch(self, keys):
        keys = np.asarray(keys, U32).reshape(-1, 4)
        B = keys.shape[0]
        self.fetches += B
        vals = np.zeros((B, 4), U32)
        found = np.zeros(B, bool)
        stamps = np.full((B, 1), -1, np.int64)
        for j, k in enumerate(keys):
            if k.tobytes() in self.data:
                vals[j], stamps[j, 0] = self.data[k.tobytes()]
                found[j] = True
        if not self.resolved:               # nobody answers fetches either
            found[:] = False
            stamps[:] = -1
        return (vals, found, stamps, np.full(B, self.source, object),
                np.zeros(B))


# each script: the cache's config, then steps the scripted backend and the
# cache run through — ("read", ids), ("put", id, value, stamp),
# ("drop", id), ("source", name), ("resolved", bool), ("invalidate", ids)
FAKE_SCRIPTS = {
    "miss_fill_then_validated_hit": (dict(capacity=16), [
        ("read", [0, 1]), ("read", [0, 1])]),
    "same_round_dedup_and_serve": (dict(capacity=16), [
        ("read", [3, 3, 3, 4])]),
    "stamp_mismatch_evicts": (dict(capacity=16), [
        ("read", [5]), ("put", 5, [9, 9, 9, 9], 999), ("read", [5])]),
    "source_flip_evicts": (dict(capacity=16), [
        ("read", [5]), ("source", "n1"), ("read", [5])]),
    "unresolved_kept_never_served": (dict(capacity=16), [
        ("read", [5]), ("resolved", False), ("read", [5]),
        ("resolved", True), ("read", [5])]),
    "delete_never_serves_ghost": (dict(capacity=16), [
        ("read", [2]), ("drop", 2), ("read", [2])]),
    "shed_is_refused": (dict(capacity=16, budget=0), [
        ("read", [0, 1, 2])]),
    "tinylfu_protects_hot_resident": (dict(capacity=1), [
        ("read", [0]), ("read", [0]), ("read", [0]), ("read", [0]),
        ("read", [7])]),
    "own_write_invalidate": (dict(capacity=16), [
        ("read", [1]), ("invalidate", [1]), ("read", [1])]),
    "trust_window_and_lru": (dict(capacity=3, trust_window=2,
                                  admission=False), [
        ("read", [0, 1, 2]), ("read", [0, 3]), ("put", 1, [7] * 4, 5),
        ("read", [1, 2, 4]), ("read", [0, 1, 2, 3, 4])]),
}


def _fake_run(P, name):
    cfg, steps = FAKE_SCRIPTS[name]
    be = FakeBackend()
    for i in range(8):
        be.put(i, [i, i, i, i], stamp=100 + i)
    c = P["cache"].ClientCache(P["cache"].CacheConfig(**cfg), be)
    log = []
    for step in steps:
        kind = step[0]
        if kind == "read":
            log.append(round_result(c.read_round(K(step[1]))))
        elif kind == "put":
            be.put(*step[1:])
        elif kind == "drop":
            be.drop(step[1])
        elif kind == "source":
            be.source = step[1]
        elif kind == "resolved":
            be.resolved = step[1]
        else:
            log.append(c.invalidate(K(step[1])))
        log.append(cache_state(c))
    log.append(be.fetches)
    return log


@pytest.mark.parametrize("name", list(FAKE_SCRIPTS))
def test_client_cache_semantics_equal_reference(name):
    ref, port = both(_fake_run, name)
    assert_same(ref, port)
    reads = [x for x in port if isinstance(x, dict) and "hit" in x]
    last, st = reads[-1], port[-2]["stats"]
    if name == "miss_fill_then_validated_hit":
        assert last["hit"].all() and st["validations"] == 2
    elif name == "stamp_mismatch_evicts":
        assert not last["hit"][0] and last["values"][0].tolist() == [9] * 4
        assert st["stamp_invalidations"] == 1
    elif name == "source_flip_evicts":
        assert st["source_invalidations"] == 1
    elif name == "unresolved_kept_never_served":
        assert not reads[1]["found"][0] and last["hit"][0]
        assert st["unresolved_validations"] == 1
    elif name == "delete_never_serves_ghost":
        assert not last["found"][0]
    elif name == "shed_is_refused":
        assert not last["served"].any() and st["shed"] == 3
    elif name == "tinylfu_protects_hot_resident":
        assert st["admit_rejects"] >= 1
        assert port[-2]["entries"][0][0] == K([0])[0].tobytes()


# ---------------------------------------------------------------------------
# ClientCache over StoreBackend, every scheme
# ---------------------------------------------------------------------------

STORE_N, STORE_SLOTS = 48, 512

# ("read", ids), ("update", ids), ("delete", ids), ("invalidate", ids),
# ("rename", name): the store's writes go through the store, as a remote
# writer's would; the backend's name stands for the answering endpoint
STORE_SCRIPTS = {
    "miss_fill_then_validated_hit": (dict(capacity=64), [
        ("read", [0, 1]), ("read", [0, 1])]),
    "same_round_dedup": (dict(capacity=64), [("read", [3, 3, 3, 4])]),
    "update_stamp_mismatch": (dict(capacity=64), [
        ("read", [5, 6]), ("update", [5]), ("read", [5, 6])]),
    "source_flip": (dict(capacity=64), [
        ("read", [5]), ("rename", "other"), ("read", [5])]),
    "delete_ghost": (dict(capacity=64), [
        ("read", [2]), ("delete", [2]), ("read", [2])]),
    "shed": (dict(capacity=64, budget=0), [("read", [0, 1, 2])]),
    "tinylfu_admission": (dict(capacity=1), [
        ("read", [0]), ("read", [0]), ("read", [0]), ("read", [7])]),
    "own_write_invalidate": (dict(capacity=64), [
        ("read", [1]), ("invalidate", [1]), ("read", [1])]),
    "update_delete_never_stale": (dict(capacity=64), [
        ("read", list(range(STORE_N))), ("update", list(range(16))),
        ("delete", list(range(16, 24))), ("read", list(range(STORE_N))),
        ("update", list(range(0, 48, 3))), ("read", list(range(STORE_N)))]),
}


def _store_run(P, scheme, name, mem):
    cfg, steps = STORE_SCRIPTS[name]
    store = P["api"].make_store(scheme, table_slots=STORE_SLOTS, **P["kw"])
    rng = np.random.RandomState(0)
    ids = np.arange(STORE_N)
    vals = ycsb.make_value(rng, STORE_N)
    table, res = store.insert(store.create(), K(ids), vals)
    okn = np.asarray(res.ok)
    truth = {int(i): v for i, v in zip(ids[okn], vals[okn])}
    endpoint = P["mem"].from_policy(store.policy.__class__(transport="sim")) \
        if mem else None
    be = P["cache"].StoreBackend(store, table, mem=endpoint)
    c = P["cache"].ClientCache(P["cache"].CacheConfig(**cfg), be)
    log = []
    for kind, arg in steps:
        if kind == "read":
            r = c.read_round(K(arg))
            for j, i in enumerate(arg):      # never a non-committed value
                if i in truth:
                    assert not r.found[j] or np.array_equal(r.values[j],
                                                            truth[i])
                else:
                    assert not r.found[j], f"id {i}: served after delete"
            log.append(round_result(r))
        elif kind == "update":
            nv = ycsb.make_value(rng, len(arg))
            be.table, ur = store.update(be.table, K(arg), nv)
            for i, v, ok in zip(arg, nv, np.asarray(ur.ok)):
                if ok:
                    truth[i] = v
        elif kind == "delete":
            be.table, dr = store.delete(be.table, K(arg))
            for i, ok in zip(arg, np.asarray(dr.ok)):
                if ok:
                    truth.pop(i, None)
        elif kind == "rename":
            be.name = arg
        else:
            log.append(c.invalidate(K(arg)))
        log.append(cache_state(c))
    log.append([int(x) for x in be.ledger])
    if endpoint is not None:
        log.append(endpoint.stats())
    return log


@pytest.mark.parametrize("name", list(STORE_SCRIPTS))
@pytest.mark.parametrize("scheme", ["continuity", "level", "pfarm", "dense"])
def test_store_backend_equals_reference(scheme, name):
    mem = name == "update_delete_never_stale"
    ref, port = both(_store_run, scheme, name, mem)
    assert_same(ref, port)
    st = port[-3 if mem else -2]["stats"]
    if name == "update_stamp_mismatch":
        assert st["stamp_invalidations"] >= 1
    elif name == "update_delete_never_stale":
        assert st["stamp_invalidations"] > 0
        assert port[-1]["by_tag"]["validate"]["verbs"] > 0
    elif name == "source_flip":
        assert st["source_invalidations"] == 1
    elif name == "shed":
        assert st["shed"] == 3


def _stamps(P):
    store = P["api"].make_store("continuity", table_slots=256, **P["kw"])
    k = K([7])
    v1 = np.array([[1, 2, 3, 4]], U32)
    v2 = np.array([[5, 6, 7, 8]], U32)
    table, _ = store.insert(store.create(), k, v1)
    s0 = np.asarray(store.version_stamp(table, k), np.int64) & 0xFFFFFFFF
    table, _ = store.update(table, k, v2)
    table, _ = store.update(table, k, v1)       # value restored (ABA)
    s2 = np.asarray(store.version_stamp(table, k), np.int64) & 0xFFFFFFFF
    r = store.lookup(table, k)
    ids = np.arange(8)
    t2, _ = store.insert(store.create(), K(ids),
                         ycsb.make_value(np.random.RandomState(0), 8))
    plan = store.version_read_plan(t2, K(ids))
    return [s0, s2, np.asarray(r.ok), np.asarray(r.values).view(U32),
            [np.asarray(leaf) for leaf in plan]]


def test_aba_stamp_and_single_8_byte_validation_plan():
    ref, port = both(_stamps)
    for a, b in zip(ref[:4], port[:4]):
        assert np.array_equal(a, b)
    for a, b in zip(ref[4], port[4]):
        assert np.array_equal(a, b)
    s0, s2, ok, values, plan = port
    assert not np.array_equal(s0, s2), \
        "stamp must advance even when the value round-trips"
    assert ok[0] and values[0].tolist() == [1, 2, 3, 4]
    verb, nbytes, depth = plan[0], plan[3], plan[4]
    active = verb == 1                          # rv.READ
    assert active.sum() == 8                    # exactly one READ per key
    assert (nbytes[active] == 8).all() and (depth[active] == 0).all()


# ---------------------------------------------------------------------------
# ClusterBackend
# ---------------------------------------------------------------------------

def _cluster_cycle(P):
    cluster = P["cluster"]("continuity", nodes=3, replicas=2,
                           node_slots=2048, **P["kw"])
    rng = np.random.RandomState(3)
    ids = np.arange(120)
    vals = ycsb.make_value(rng, 120)
    res = cluster.insert(K(ids), vals)
    backend = P["cache"].ClusterBackend(cluster)
    cache = P["cache"].ClientCache(P["cache"].CacheConfig(capacity=128),
                                   backend)
    log = [np.asarray(res.ok), round_result(cache.read_round(K(ids)))]
    victim = str(cluster.directory.replica_names(K(ids[:1]))[0, 0])
    cluster.partition(victim)
    cluster.stale_write(victim, K(ids[:8]), ycsb.make_value(rng, 8))
    up = ids[rng.permutation(120)[:24]]
    log.append(np.asarray(cluster.update(K(up),
                                         ycsb.make_value(rng, 24)).ok))
    log.append(round_result(cache.read_round(K(ids))))
    cluster.heal(victim)
    log.append(round_result(cache.read_round(K(ids))))   # lagging: fenced
    hr = cluster.resync(victim)
    log.append((hr.node, hr.stale_acks_detected, hr.resynced))
    up = ids[rng.permutation(120)[:24]]
    log.append(np.asarray(cluster.update(K(up),
                                         ycsb.make_value(rng, 24)).ok))
    log.append(round_result(cache.read_round(K(ids))))
    log.append([(k, sorted(s), u) for k, s, u in backend.last])
    log.append(cache_state(cache))
    log.append(cluster.stats())
    return log


def test_cluster_backend_partition_cycle_equals_reference():
    ref, port = both(_cluster_cycle)
    assert_same(ref, port)
    assert port[5][1] == 8                          # every stale ack
    assert port[-2]["stats"]["stamp_invalidations"] > 0
    tags = {}
    for st in port[-1]["nodes"].values():
        for tag, row in st.get("wire", {}).get("by_tag", {}).items():
            tags[tag] = tags.get(tag, 0) + row["verbs"]
    assert tags["fill"] > 0 and tags["validate"] > 0


def _tagged(P):
    cluster = P["cluster"]("continuity", nodes=3, replicas=2,
                           node_slots=1024, **P["kw"])
    ids = np.arange(40)
    cluster.insert(K(ids), ycsb.make_value(np.random.RandomState(0), 40))
    cache = P["cache"].ClientCache(P["cache"].CacheConfig(capacity=64),
                                   P["cache"].ClusterBackend(cluster))
    cache.read_round(K(ids))            # fills
    cache.read_round(K(ids))            # validations
    return cluster.stats()


def test_cluster_backend_tags_wire_traffic_as_reference():
    ref, port = both(_tagged)
    assert_same(ref, port)
    tags = {}
    for st in port["nodes"].values():
        for tag, row in st.get("wire", {}).get("by_tag", {}).items():
            agg = tags.setdefault(tag, {"verbs": 0, "bytes": 0})
            agg["verbs"] += row["verbs"]
            agg["bytes"] += row["bytes"]
    assert tags["fill"]["verbs"] > 0
    # every validate verb is the 8-byte indicator word, nothing more
    assert tags["validate"]["verbs"] == 40
    assert tags["validate"]["bytes"] == 8 * 40


def test_tiny_fanin_full_chaos_schedule_equals_reference():
    events = [(2, "partition", "primary"), (2, "stale", ""),
              (3, "heal", ""), (4, "resync", ""),
              (5, "kill", "primary"), (6, "failover", "")]
    kw = dict(clients=6, rounds=7, ops_per_round=6, writes_per_round=1,
              num_records=300, nodes=3, replicas=2, budget=None,
              events=events)
    port = tfanin.run_fanin("continuity", device="cpu", **kw)
    ref = jfanin.run_fanin("continuity", **kw)
    assert json.dumps(port, sort_keys=True, default=str) == \
        json.dumps(ref, sort_keys=True, default=str)
    assert_same(ref, port)
    ca, un = port["cached"], port["uncached"]
    assert ca["stale_served"] == 0
    assert ca["wrong_reads"] == 0 and un["wrong_reads"] == 0
    assert port["stream_check"]["ok"]
    assert port["doorbell_reduction"] > 1.0
    fired = {e["event"] for e in ca["events"]}
    assert {"partition", "stale", "heal", "resync",
            "kill", "failover"} <= fired
