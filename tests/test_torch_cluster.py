"""The port's cluster layer (`repro_torch.cluster`) against the JAX
package's, on the CPU.

Every scenario drives a reference `ClusterStore` and the port's
(``device="cpu"``) through the same calls on the same seeded keys and
compares everything either returns — per-op results, rebalance, failover
and heal reports, `stats()` with every endpoint's wire counters, the
chaos and maintenance counters — and every node's table byte for byte
(``convert.*_to_numpy``).  The scenarios carry the intent of
``tests/test_cluster.py`` and of the cluster cases of
``tests/test_chaos.py`` and ``tests/test_obs.py``: routing, replicated
writes and reads, dual-read joins within 1/N + 5 %, leave, kill and
heartbeat failover with log-free recovery, failover inside a migration
window, partition / stale write / heal / resync, quorum-loss read-only,
exhausted retry budgets, version stamps and scans (the online split
under traffic and its SLO accounting are in ``test_torch_obs_export.py``).  The ``--smoke`` drill's payload
and JSON equal the reference's field by field; the directory's device
routing is bit-exact to its numpy routing on 2**20 keys; the port's
`_distinct_resident` keeps the reference's order and values.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import obs as jobs
from repro.cluster import sim as jsim
from repro.cluster.failover import FailoverController as JFC
from repro.cluster.store import ClusterStore as JCluster
from repro.rdma.transport import FaultInjector as JFaults
from repro.rdma.transport import RetryPolicy as JRetry
from repro_torch import convert, obs
from repro_torch.cluster import Directory, sim
from repro_torch.cluster import store as cstore
from repro_torch.cluster.failover import FailoverController as TFC
from repro_torch.cluster.store import ClusterStore as TCluster
from repro_torch.data import ycsb
from repro_torch.rdma.transport import FaultInjector as TFaults
from repro_torch.rdma.transport import RetryPolicy as TRetry

# every scenario sizes its nodes as the --smoke drill does (one table
# geometry: the reference compiles its ops once per module)
SLOTS = 1156
REF = dict(C=JCluster, FC=JFC, F=JFaults, R=JRetry, obs=jobs)
PORT = dict(C=functools.partial(TCluster, device="cpu"), FC=TFC, F=TFaults,
            R=TRetry, obs=obs)


def kv(n, seed=0, lo=0):
    rng = np.random.RandomState(seed)
    return ycsb.make_key(np.arange(lo, lo + n)), ycsb.make_value(rng, n)


def _table_np(table) -> dict:
    if isinstance(table, tuple) and isinstance(table[0], torch.Tensor):
        fn = {"ContinuityTable": convert.table_to_numpy,
              "LevelTable": convert.level_table_to_numpy,
              "PFarmTable": convert.pfarm_table_to_numpy,
              "DenseTable": convert.dense_table_to_numpy}
        return fn[type(table).__name__](table)
    return {f: np.asarray(getattr(table, f)) for f in table._fields}


def snapshot(c) -> dict:
    """Everything observable about a cluster: stats, membership, and each
    node's tables (both images mid-split)."""
    out = {"stats": c.stats(), "nodes": c.node_names(),
           "directory": c.directory.nodes, "epoch": c.epoch,
           "read_only": c.read_only, "migrating": c.migrating,
           "tables": {}}
    for name in c.node_names():
        n = c.node(name)
        t = {"table": _table_np(n.table), "alive": n.alive,
             "reachable": n.reachable, "epoch": n.epoch}
        if n.resize is not None:
            t["new_table"] = _table_np(n.resize.new_table)
        out["tables"][name] = t
    return out


def result(r):
    """A NamedTuple / dataclass result as comparable plain data."""
    if dataclasses.is_dataclass(r):
        d = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
        if "new_dir" in d:                       # a begin_join handle
            d["new_dir"] = (d["new_dir"].nodes, d["new_dir"].replicas)
        if "recovery" in d:
            d["recovery"] = {k: dataclasses.asdict(v)
                             for k, v in d["recovery"].items()}
        for prop in ("moved_frac", "within_bound"):
            if hasattr(r, prop):
                d[prop] = getattr(r, prop)
        return d
    return {f: np.asarray(v) if isinstance(v, np.ndarray) else v
            for f, v in zip(r._fields, r)}


def assert_same(a, b, path="$"):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), \
            (path, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def both(scenario, **kw):
    return scenario(REF, **kw), scenario(PORT, **kw)


# ---------------------------------------------------------------------------
# scenarios: each drives one package and records what it observes
# ---------------------------------------------------------------------------

def scen_read_write(P, scheme):
    c = P["C"](scheme, nodes=3, replicas=2, node_slots=SLOTS)
    K, V = kv(180, seed=1)
    log = [result(c.insert(K, V))]
    log.append(result(c.lookup(K)))
    rng = np.random.RandomState(2)
    V2 = ycsb.make_value(rng, 40)
    log.append(result(c.update(K[:40], V2)))
    log.append(result(c.delete(K[40:60])))
    log.append(result(c.lookup(K[:80])))
    dup = np.concatenate([K[:10], K[:10]])
    log.append(result(c.update(dup, ycsb.make_value(rng, 20))))
    log.append(c.total_resident())
    log.append(snapshot(c))
    return log


@pytest.fixture(scope="module", params=["continuity", "level"])
def read_write(request):
    return both(scen_read_write, scheme=request.param)


def test_writes_and_reads_match_reference(read_write):
    ref, port = read_write
    assert_same(ref[:-1], port[:-1])
    assert port[1]["found"].all()
    assert port[-2] == 180 - 20


def test_node_tables_after_writes_match_reference(read_write):
    ref, port = read_write
    assert_same(ref[-1], port[-1])
    resident = [n["resident"] for n in port[-1]["stats"]["nodes"].values()]
    assert sum(resident) == 2 * 160        # every live key on R nodes


def scen_join_leave(P):
    c = P["C"]("continuity", nodes=3, replicas=2, node_slots=SLOTS)
    K, V = kv(180, seed=1)
    c.insert(K, V)
    log = [result(c.begin_join("pmX", SLOTS)), snapshot(c)]
    log.append(result(c.lookup(K)))            # the dual-read window
    log.append(result(c.update(K[:30], V[:30] ^ np.uint32(7))))
    log.append(result(c.complete_join()))
    log.append(result(c.lookup(K)))
    log.append(snapshot(c))
    log.append(result(c.leave("pm1")))
    log.append(result(c.lookup(K)))
    log.append(snapshot(c))
    return log


@pytest.fixture(scope="module")
def join_leave():
    return both(scen_join_leave)


def test_join_and_leave_match_reference(join_leave):
    ref, port = join_leave
    assert_same(ref, port)
    rb = port[4]
    assert rb["within_bound"] and rb["moved_primary"] > 0
    assert port[2]["found"].all() and port[5]["found"].all()
    assert port[8]["found"].all() and "pm1" not in port[9]["nodes"]


def scen_failover(P):
    c = P["C"]("continuity", nodes=3, replicas=2, node_slots=SLOTS)
    K, V = kv(180, seed=1)
    c.insert(K, V)
    clock = [0.0]
    ctl = P["FC"](c, timeout_s=2.0, clock=lambda: clock[0])
    victim = str(c.directory.replica_names(K[:1])[0, 0])
    c.kill(victim)
    log = [result(c.lookup(K))]                 # degraded replica reads
    reps = []
    for step in range(4):
        clock[0] += 1.0
        ctl.beat(step)
        reps += [result(r) for r in ctl.tick()]
    log += [reps, result(c.lookup(K)), snapshot(c)]
    # a primary dies inside a migration window; then the joiner itself
    c.begin_join("pmX", SLOTS)
    other = next(n for n in c.node_names() if n != "pmX")
    c.kill(other)
    log.append(result(c.failover(other)))
    log.append(c.migrating)
    log.append(result(c.complete_join()))
    c.begin_join("pmY", SLOTS)
    c.kill("pmY")
    log.append(result(c.failover("pmY")))
    log += [c.migrating, result(c.lookup(K)), snapshot(c)]
    return log


@pytest.fixture(scope="module")
def failover():
    return both(scen_failover)


def test_failover_matches_reference(failover):
    ref, port = failover
    assert_same(ref, port)
    assert port[0]["found"].all()
    reps = port[1]
    assert len(reps) == 1 and reps[0]["promoted_keys"] > 0
    assert all(v["log_records_used"] == 0 and v["log_records_scanned"] == 0
               for v in reps[0]["recovery"].values())
    assert port[2]["found"].all() and port[-2]["found"].all()
    assert not port[-3]                        # the joiner's death voids it


def scen_chaos(P):
    c = P["C"]("continuity", nodes=4, replicas=2, node_slots=SLOTS)
    K, V = kv(200)
    log = [result(c.insert(K, V))]
    c.partition("pm1")
    log.append(c.stale_write("pm1", K[:32], V[:32] ^ np.uint32(0xDEAD)))
    c.heal("pm1")
    log.append((c._name_lagging("pm1"), c._name_serving("pm1")))
    log.append(result(c.lookup(K)))            # routes around the lagging
    log.append(result(c.resync("pm1")))
    log.append(result(c.lookup(K)))
    log.append(snapshot(c))
    c.partition("pm2")
    c.stale_write("pm2", K[32:48], V[32:48] ^ np.uint32(1))
    log.append(result(c.failover("pm2")))      # declared failed while cut off
    c.partition("pm3")
    c.heal("pm3")
    log.append(result(c.join("pm9", SLOTS)))    # unrelated churn
    log.append((c._name_lagging("pm3"), c._name_serving("pm3")))
    log.append(result(c.resync("pm3")))
    log.append(result(c.lookup(K)))
    log.append(snapshot(c))
    return log


@pytest.fixture(scope="module")
def chaos():
    return both(scen_chaos)


def test_partition_stale_heal_resync_match_reference(chaos):
    ref, port = chaos
    assert_same(ref, port)
    assert port[1] == 32 and port[2] == (True, False)
    assert port[4]["stale_acks_detected"] == 32
    assert port[5]["found"].all() and port[-2]["found"].all()
    ch = port[-1]["stats"]["chaos"]
    assert ch["stale_acks_detected"] == ch["stale_acks_injected"] == 48
    assert ch["lag_read_redirects"] > 0


def scen_degrade(P):
    c = P["C"]("continuity", nodes=3, replicas=2, node_slots=SLOTS)
    K, V = kv(150)
    c.insert(K, V)
    for dead in ("pm2", "pm1"):
        c.kill(dead)
        c.failover(dead)
    K2, V2 = kv(10, seed=1, lo=1000)
    log = [c.read_only, result(c.insert(K2, V2)), result(c.lookup(K)),
           snapshot(c)]
    c = P["C"]("continuity", nodes=4, replicas=2, node_slots=SLOTS)
    K, V = kv(100)
    c.insert(K, V)
    for name in c.node_names():
        node = c.node(name)
        node.mem.faults = P["F"](drop_p=1.0, seed=7)
        node.mem.retry = P["R"](max_attempts=2)
    log.append(result(c.update(K[:32], V[:32] ^ np.uint32(5))))
    log.append(result(c.lookup(K[:8])))        # reads time out too
    c.quiesce_faults()
    log += [result(c.lookup(K)), snapshot(c)]
    return log


@pytest.fixture(scope="module")
def degrade():
    return both(scen_degrade)


def test_read_only_and_timeouts_match_reference(degrade):
    ref, port = degrade
    assert_same(ref, port)
    assert port[0] and not port[1]["ok"].any() and port[2]["found"].all()
    assert not port[4]["ok"].any() and port[6]["found"].all()
    ch = port[-1]["stats"]["chaos"]
    assert ch["write_timeouts"] > 0 and ch["read_timeouts"] > 0


def scen_stamps_scans(P):
    c = P["C"]("continuity", nodes=3, replicas=2, node_slots=SLOTS)
    K, V = kv(150, seed=3)
    c.insert(K, V)
    log = [result(c.lookup_stamped(K)), result(c.version_read(K))]
    c.update(K[:20], V[:20] ^ np.uint32(9))
    log += [result(c.version_read(K)), result(c.scan(K[:50],
                                                     np.arange(50) % 7))]
    c.begin_join("pmJ", SLOTS)
    log += [result(c.lookup_stamped(K)), result(c.version_read(K))]
    c.complete_join()
    log += [result(c.scan(K, np.full(150, 3))), snapshot(c)]
    return log


def test_stamps_and_scans_match_reference():
    ref, port = both(scen_stamps_scans)
    assert_same(ref, port)
    assert port[0]["found"].all() and port[1]["resolved"].all()
    assert (port[2]["stamps"] != port[1]["stamps"]).any()


# ---------------------------------------------------------------------------
# the drill: run_cluster and the --smoke CLI
# ---------------------------------------------------------------------------

def _plain(payload):
    return json.loads(json.dumps(payload, sort_keys=True, default=str))


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    d = tmp_path_factory.mktemp("smoke")
    assert jsim.main(["--smoke", "--json", str(d / "ref.json")]) == 0
    assert sim.main(["--smoke", "--device", "cpu",
                     "--json", str(d / "port.json")]) == 0
    return (json.loads((d / "ref.json").read_text()),
            json.loads((d / "port.json").read_text()))


def test_smoke_payload_matches_reference(smoke):
    ref, port = smoke
    assert_same(ref, port)
    cell = port["cluster"]
    assert cell["committed"] == 600 and cell["committed_lost"] == 0
    assert cell["rebalance_within_bound"] and cell["failover_detected"]
    join = next(e for e in cell["events"] if e["event"] == "join")
    assert join["moved_frac"] <= join["bound"] == 0.25
    assert port["durability"]["ok"] and port["migration"]["ok"]
    assert port["migration"]["log_free"]


@pytest.mark.parametrize("case", [
    dict(workload="F", dist="hotspot", seed=4,
         events=(("partition", 60, "pm1"), ("stale", 80, "pm1"),
                 ("heal", 120, "pm1"), ("resync", 160, "pm1"),
                 ("leave", 200, "pm2"))),
    dict(workload="D", seed=6, grace_s=3.0,
         events=(("kill", 100, "primary"),)),
], ids=["F-partition", "D-grace"])
def test_run_cluster_cells_match_reference(case):
    kw = dict(nodes=3, replicas=2, num_records=160, num_ops=240, batch=40,
              node_slots=SLOTS, **case)
    ref = jsim.run_cluster("continuity", **kw)
    port = sim.run_cluster("continuity", device="cpu", **kw)
    assert_same(_plain(ref), _plain(port))
    assert port["committed_lost"] == 0


def test_cache_drill_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 #5"):
        sim.main(["--cache", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the port's own machinery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("members", [("pm0", "pm1", "pm2", "pm3"),
                                     ("pm0", "pm1", "pm2", "pm3", "pmJ"),
                                     ("a", "b", "c")])
def test_device_routing_is_bit_exact(members):
    from repro.cluster.directory import Directory as JD
    rng = np.random.RandomState(len(members))
    keys = np.concatenate([
        ycsb.make_key(np.arange(2 ** 19)),
        rng.randint(0, 2 ** 32, size=(2 ** 19, 4), dtype=np.uint64
                    ).astype(np.uint32)])
    for r in (1, 2, 3):
        d = Directory(members, replicas=r)
        want = JD(members, replicas=r).replica_sets(keys)
        got = d.replica_sets_t(torch.from_numpy(keys.view(np.int32)))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(d.replica_sets(keys), want)
        own = d.owned_mask_t(torch.from_numpy(keys[:4096].view(np.int32)),
                             members[1], "replica")
        np.testing.assert_array_equal(
            own.numpy(), JD(members, r).owned_mask(keys[:4096], members[1],
                                                   "replica"))
        jd = JD(members, r)
        for role in ("primary", "replica", "any"):
            np.testing.assert_array_equal(
                d.owned_mask(keys[:4096], members[0], role),
                jd.owned_mask(keys[:4096], members[0], role))
        np.testing.assert_array_equal(d.primaries(keys), jd.primaries(keys))
        np.testing.assert_array_equal(d.replica_names(keys[:4096]),
                                      jd.replica_names(keys[:4096]))
    from repro.cluster.directory import key_hash64 as jhash
    from repro_torch.cluster import key_hash64
    np.testing.assert_array_equal(key_hash64(keys), jhash(keys))


def test_distinct_resident_keeps_reference_order_and_values():
    """Leftover copies outrank nothing: after a join whose cleanup is
    skipped and an update that only current owners take, each key keeps
    its current owners' value, in the reference's first-seen order."""
    cs = []
    for P in (REF, PORT):
        c = P["C"]("continuity", nodes=3, replicas=2, node_slots=SLOTS)
        K, V = kv(120, seed=8)
        c.insert(K, V)
        c.begin_join("pmX", SLOTS)
        c.directory = c._mig.new_dir       # cut over without cleanup
        c._mig = None
        c.update(K, V ^ np.uint32(3))
        cs.append(c)
    jK, jV = cs[0]._distinct_resident()
    tK, tV = cs[1]._distinct_resident()
    np.testing.assert_array_equal(tK.numpy().view(np.uint32), jK)
    np.testing.assert_array_equal(tV.numpy().view(np.uint32), jV)
    K, V = kv(120, seed=8)
    want = {k.tobytes(): v ^ np.uint32(3) for k, v in zip(K, V)}
    assert len(jK) == 120
    assert all((want[k.tobytes()] == v).all() for k, v in zip(jK, jV))
    leftovers = sum(cs[1].stats()["nodes"][n]["resident"]
                    for n in cs[1].node_names()) - 2 * 120
    assert leftovers > 0                 # un-cleaned copies were present


def test_sliced_join_equals_single_batch_until_the_pool_runs_out(
        monkeypatch):
    """The joiner's share goes into the store in slices of `CALL_ROWS`.
    With room in the extension pool the sliced insert leaves the
    reference's table; with a pool that runs out inside the copy, the
    slices grant extension groups in arrival order and the tables
    differ, as `continuity.resize`'s chunks do (ROADMAP Queue 3)."""
    def joined(P, slots):
        c = P["C"]("continuity", nodes=2, replicas=1, node_slots=SLOTS)
        K, V = kv(900, seed=9)
        c.insert(K, V)
        c.join("pmJ", slots)
        return _table_np(c.node("pmJ").table)

    want = {slots: joined(REF, slots) for slots in (SLOTS, 330)}
    monkeypatch.setattr(cstore, "CALL_ROWS", 64)
    for slots, equal in ((SLOTS, True), (330, False)):
        got = joined(PORT, slots)
        same = all(np.array_equal(want[slots][f], got[f]) for f in got)
        assert same == equal, slots
    monkeypatch.setattr(cstore, "CALL_ROWS", 1 << 22)
    assert_same(want[330], joined(PORT, 330))


def test_torn_updates_are_repaired_unlike_the_reference():
    """Nodes near full: a member with no free slot in a key's segment
    refuses an update the other member applies, so the op is not acked.
    The reference leaves the replicas diverged and a read can return the
    un-acked value; the port sets every replica back to the last acked
    value (a deliberate divergence, ROADMAP Queue 3).  The same ops are
    acked on both."""
    wrong, acked = [], []
    for P in (REF, PORT):
        c = P["C"]("continuity", nodes=3, replicas=2, node_slots=SLOTS)
        K, V = kv(1300)
        assert np.asarray(c.insert(K, V).ok).all()
        V2 = kv(1300, seed=1)[1]
        ok = np.asarray(c.update(K, V2).ok)
        want = np.where(ok[:, None], V2, V)
        got = np.asarray(c.lookup(K).values)
        wrong.append(int((got != want).any(axis=1).sum()))
        acked.append(ok)
    assert_same(acked[0], acked[1])
    assert 0 < acked[1].sum() < len(acked[1])
    assert wrong[0] > 0 and wrong[1] == 0
    assert c.torn_repaired > 0


@pytest.mark.parametrize("slots", [280, 300])
def test_small_nodes_lose_no_acked_value(slots):
    """The --smoke cell on nodes so small that updates, the failover's
    refresh and the join's copies meet full segments: with the repairs
    every acked value reads back (the reference's audit counts 45 and 30
    of 600 lost at these sizes, ROADMAP Queue 3)."""
    cell = sim.run_cluster(device="cpu", node_slots=slots,
                           **sim.smoke_kwargs(True))
    assert cell["committed"] == 600 and cell["committed_lost"] == 0
    assert cell["rebalance_within_bound"] and cell["failover_detected"]


def test_api_exports_cluster_store_lazily():
    import repro_torch.api as tapi
    assert "ClusterStore" in tapi.__all__
    assert tapi.ClusterStore is TCluster
    assert japi.ClusterStore is JCluster
    with pytest.raises(AttributeError):
        tapi.NoSuchThing


def test_cluster_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCluster("continuity", nodes=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.run_cluster(num_records=10, num_ops=10, batch=10)
