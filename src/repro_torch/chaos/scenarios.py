"""Named chaos scenarios: each composes faults into one audited cell.

Port of ``repro.chaos.scenarios``: the same cells, checks and payloads,
with every cluster's node tables on ``device`` (the card unless the
caller asks for the CPU).

A scenario is a recipe ``(scheme, workload, seed, sizes, device) -> cell
dict``.
Most drive `cluster.sim.run_cluster` with an event schedule derived from
the run length (storms, partitions, churn); two are direct drills on a
`ClusterStore` for paths a YCSB run cannot force deterministically
(quorum-loss read-only, retry-budget exhaustion).  Every cell carries
the same shape:

    scenario / scheme / workload / seed    the cell's coordinates
    checks      {name: bool} — the invariants THIS scenario asserts
    ok          all(checks.values())
    committed_lost, chaos, wire            the audit + counter payload

The ONE seed in the cell is the only entropy: the YCSB streams, the
event payloads, and the delivery-fault draws all derive from it, so any
failing cell replays bit-exactly from its coordinates.

Invariants by scenario family:

  * storms (correlated kills, mid-join, mid-migration): zero committed
    loss, every kill detected and promoted, rebalance bound holds;
  * partitions: zero committed loss AND fencing completeness — every
    stale ack the partitioned ex-primary took is detected at
    resync/failover and none is visible afterwards;
  * delivery faults: zero committed loss with drops retried (capped
    exponential backoff), duplicates absorbed, reorders re-synced;
  * degradation drills: quorum loss rejects writes (never acks it could
    lose) while reads keep serving; an exhausted retry budget surfaces
    as an UN-acked round, not a lost one.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.cluster.sim import run_cluster
from repro_torch.cluster.store import ClusterStore
from repro_torch.data import ycsb
from repro_torch.rdma.transport import FaultInjector, RetryPolicy

# one grid-wide knob set per profile (the reference's: identical
# node_slots/batch across cells)
SIZES = {
    "smoke": dict(num_records=400, num_ops=800, batch=200, node_slots=2048),
    "full": dict(num_records=1000, num_ops=2000, batch=250, node_slots=4096),
}

_WIRE_KEYS = ("retries", "timeouts", "duplicates", "reorders",
              "backoff_us", "give_ups")


def _mild_faults(seed: int) -> FaultInjector:
    """The grid's background weather: drop/dup/reorder rates high enough
    to exercise every retry path in a few thousand rounds, low enough
    that the retry budget (8 attempts) never exhausts by chance
    (P(give-up) = drop_p^8 ~ 2.6e-6 per round at 0.2)."""
    return FaultInjector(drop_p=0.10, dup_p=0.05, reorder_p=0.05, seed=seed)


def _wire_totals(stats: dict) -> Dict[str, float]:
    tot = {k: 0.0 for k in _WIRE_KEYS}
    for st in stats.get("nodes", {}).values():
        for k in _WIRE_KEYS:
            tot[k] += st.get("wire", {}).get(k, 0)
    return tot


def _cell(scenario: str, scheme: str, workload: str, seed: int,
          checks: Dict[str, bool], payload: dict) -> dict:
    return {
        "scenario": scenario, "scheme": scheme, "workload": workload,
        "seed": seed, "checks": checks, "ok": all(checks.values()),
        "committed_lost": payload.get("committed_lost", 0),
        "chaos": payload.get("chaos", {}),
        "wire": _wire_totals(payload.get("stats", {})),
        "events": [e.get("event", "?") for e in payload.get("events", [])],
        "ops_per_s": payload.get("ops_per_s", 0.0),
    }


def _fencing_checks(c: dict) -> Dict[str, bool]:
    ch = c["chaos"]
    return {
        "zero_committed_loss": c["committed_lost"] == 0,
        "stale_acks_all_detected":
            ch["stale_acks_detected"] == ch["stale_acks_injected"],
        "stale_acks_present": ch["stale_acks_injected"] > 0,
    }


# -- storm family -----------------------------------------------------------
def storm(scheme: str, workload: str, seed: int, sizes: dict,
          device: str) -> dict:
    """Correlated multi-node crash storm: two nodes of a 6-node R=3
    cluster die in the SAME round (<= R-1, so every key keeps a copy),
    a third dies later; heartbeats detect, replicas promote, R is
    restored — and every acked op survives."""
    quarter, three_q = sizes["num_ops"] // 4, 3 * sizes["num_ops"] // 4
    # tight detection + wide spacing: the storm's later kill must land
    # AFTER the first two promotions re-replicated (detection takes two
    # silent rounds), or three failures would overlap — beyond the
    # <= R-1 SIMULTANEOUS-failure contract — and acks taken in the
    # window would genuinely lose their last copy
    c = run_cluster(scheme, workload, nodes=6, replicas=3,
                    events=[("kill", quarter, "pm1"),
                            ("kill", quarter, "pm4"),
                            ("kill", three_q, "pm2")],
                    seed=seed, heartbeat_timeout=1.0,
                    faults=_mild_faults(seed),
                    retry=RetryPolicy(), device=device, **sizes)
    return _cell("storm", scheme, workload, seed, {
        "zero_committed_loss": c["committed_lost"] == 0,
        "all_kills_promoted":
            sum(1 for e in c["events"] if e["event"] == "failover") == 3,
        "log_free_recovery": all(e.get("recovery_log_free", True)
                                 for e in c["events"]),
    }, c)


def storm_mid_join(scheme: str, workload: str, seed: int,
                   sizes: dict, device: str) -> dict:
    """A primary dies INSIDE a join's dual-read window: the pending
    cutover must re-target the post-failover membership instead of
    resurrecting the dead node."""
    t = sizes["num_ops"] // 3
    c = run_cluster(scheme, workload, nodes=4, replicas=2,
                    events=[("join", t, "pmJ"), ("kill", t, "pm0")],
                    seed=seed, faults=_mild_faults(seed),
                    retry=RetryPolicy(), device=device, **sizes)
    return _cell("storm_mid_join", scheme, workload, seed, {
        "zero_committed_loss": c["committed_lost"] == 0,
        "kill_promoted": any(e["event"] == "failover" for e in c["events"]),
        "rebalance_within_bound": c["rebalance_within_bound"],
    }, c)


def storm_mid_migration(scheme: str, workload: str, seed: int,
                        sizes: dict, device: str) -> dict:
    """The JOINER dies inside its own migration window: it owned nothing
    yet, so the join is void — the source stays authoritative and no
    key may be lost or double-homed."""
    t = sizes["num_ops"] // 3
    c = run_cluster(scheme, workload, nodes=4, replicas=2,
                    events=[("join", t, "pmJ"), ("kill", t, "pmJ")],
                    seed=seed, device=device, **sizes)
    return _cell("storm_mid_migration", scheme, workload, seed, {
        "zero_committed_loss": c["committed_lost"] == 0,
        "join_voided": c["nodes_final"] == 4,
        "joiner_death_detected":
            any(e["event"] == "failover" and e["dead"] == "pmJ"
                for e in c["events"]),
    }, c)


# -- partition family -------------------------------------------------------
def partition_fence(scheme: str, workload: str, seed: int,
                    sizes: dict, device: str) -> dict:
    """Partition -> stale unfenced acks -> heal inside the suspicion
    grace window -> resync.  The grace window keeps the monitor from
    promoting (the node is partitioned, NOT dead); the epoch fence
    detects every stale ack at resync and none survives."""
    q = sizes["num_ops"] // 4
    c = run_cluster(scheme, workload, nodes=4, replicas=2,
                    events=[("partition", q, "pm1"), ("stale", q + 1, "pm1"),
                            ("heal", 2 * q, "pm1"), ("resync", 3 * q, "pm1")],
                    seed=seed, heartbeat_timeout=1.0, grace_s=20.0,
                    device=device, **sizes)
    checks = _fencing_checks(c)
    checks["not_promoted_while_suspect"] = not any(
        e["event"] == "failover" for e in c["events"])
    return _cell("partition_fence", scheme, workload, seed, checks, c)


def partition_failover(scheme: str, workload: str, seed: int,
                       sizes: dict, device: str) -> dict:
    """Partition that OUTLASTS the grace window: the suspect node is
    declared failed, promoted away, and its stale acks are detected at
    failover instead of resync — the fenced ex-primary path."""
    t = sizes["num_ops"] // 3
    c = run_cluster(scheme, workload, nodes=4, replicas=2,
                    events=[("partition", t, "pm2"),
                            ("stale", t + 1, "pm2")],
                    seed=seed, heartbeat_timeout=1.0, grace_s=1.0,
                    device=device, **sizes)
    checks = _fencing_checks(c)
    checks["partition_promoted"] = any(
        e["event"] == "failover" and e["dead"] == "pm2"
        for e in c["events"])
    return _cell("partition_failover", scheme, workload, seed, checks, c)


def lag_reads(scheme: str, workload: str, seed: int, sizes: dict,
              device: str) -> dict:
    """Replica-lag reads: a healed-but-unsynced node looks reachable but
    holds a stale epoch; reads ranked to it MUST redirect to a serving
    replica (a lagging image never serves) until resync re-admits it."""
    q = sizes["num_ops"] // 4
    c = run_cluster(scheme, workload, nodes=4, replicas=2,
                    events=[("partition", q, "pm1"), ("heal", q + 1, "pm1"),
                            ("resync", 3 * q, "pm1")],
                    seed=seed, device=device, **sizes)
    return _cell("lag_reads", scheme, workload, seed, {
        "zero_committed_loss": c["committed_lost"] == 0,
        "lag_reads_redirected": c["chaos"]["lag_read_redirects"] > 0,
    }, c)


# -- delivery-fault family --------------------------------------------------
def delivery_faults(scheme: str, workload: str, seed: int,
                    sizes: dict, device: str) -> dict:
    """Lossy wire, no membership events: drops are timed out and
    retried with capped exponential backoff, duplicates absorbed,
    reorders re-synced — and the YCSB run stays lossless."""
    c = run_cluster(scheme, workload, nodes=4, replicas=2, seed=seed,
                    faults=_mild_faults(seed), retry=RetryPolicy(),
                    device=device, **sizes)
    w = _wire_totals(c["stats"])
    # duplicates/reorders fire at 5% per round — a single small cell can
    # legitimately draw none, so THOSE paths gate at the grid level
    # (matrix totals), not per cell
    return _cell("delivery_faults", scheme, workload, seed, {
        "zero_committed_loss": c["committed_lost"] == 0,
        "drops_retried": w["retries"] > 0,
        "backoff_waited": w["backoff_us"] > 0,
        "no_spurious_give_ups": w["give_ups"] == 0,
    }, c)


# -- degradation drills -----------------------------------------------------
def read_only_degrade(scheme: str, workload: str, seed: int,
                      sizes: dict, device: str) -> dict:
    """Quorum loss: sequential kill+failover down to fewer serving nodes
    than the replication factor.  The cluster flips to read-only —
    every write is REJECTED (never acked under-replicated) while every
    previously acked key still reads back exactly."""
    rng = np.random.RandomState(seed)
    n = sizes["num_records"]
    cluster = ClusterStore(scheme, nodes=3, replicas=2,
                           node_slots=sizes["node_slots"], device=device)
    K = ycsb.make_key(np.arange(n))
    V = ycsb.make_value(rng, n)
    res = cluster.insert(K, V)
    acked = np.asarray(res.ok)
    for name in ("pm2", "pm1"):         # sequential: failover restores R
        cluster.kill(name)              # between kills where it still can
        cluster.failover(name)
    w = cluster.insert(ycsb.make_key(np.arange(n, n + 32)),
                       ycsb.make_value(rng, 32))
    rd = cluster.lookup(K[acked])
    good = np.asarray(rd.found) & (rd.values == V[acked]).all(axis=1)
    payload = {"committed_lost": int((~good).sum()),
               "chaos": dict(cluster.chaos), "stats": cluster.stats()}
    return _cell("read_only_degrade", scheme, workload, seed, {
        "went_read_only": cluster.read_only,
        "writes_rejected": (not w.ok.any()
                            and cluster.chaos["writes_rejected_read_only"]
                            > 0),
        "reads_still_serve": bool(good.all()),
    }, payload)


def timeout_giveup(scheme: str, workload: str, seed: int,
                   sizes: dict, device: str) -> dict:
    """Retry-budget exhaustion: a 100%-loss wire makes every delivery
    round drain its attempts and raise.  The cluster must surface that
    as UN-acked ops (the client saw no commit, so nothing is lost) —
    and recover to full service the moment the wire heals."""
    rng = np.random.RandomState(seed)
    n = sizes["num_records"]
    cluster = ClusterStore(scheme, nodes=3, replicas=2,
                           node_slots=sizes["node_slots"], device=device)
    K = ycsb.make_key(np.arange(n))
    V = ycsb.make_value(rng, n)
    acked = np.asarray(cluster.insert(K, V).ok)
    # the wire goes fully lossy AFTER the load: every endpoint now drops
    # every delivery, so each round exhausts its (shortened) budget
    for name in cluster.node_names():
        mem = cluster.node(name).mem
        mem.faults = FaultInjector(drop_p=1.0, seed=seed)
        mem.retry = RetryPolicy(max_attempts=3)
    W = ycsb.make_value(rng, 64)
    w = cluster.update(K[acked][:64], W)
    give_ups = _wire_totals(cluster.stats())["give_ups"]
    timeouts_seen = (cluster.chaos["write_timeouts"]
                     + cluster.chaos["read_timeouts"])
    cluster.quiesce_faults()            # the wire heals
    rd = cluster.lookup(K[acked])
    found = np.asarray(rd.found)
    # the 64 targeted keys are INDETERMINATE: the update applied on the
    # shard before its ack round died, so either value is legal — the
    # client was never told it committed.  Every untargeted key must
    # hold its exact acked value.
    old = (rd.values == V[acked]).all(axis=1)
    new = np.zeros_like(old)
    new[:64] = (rd.values[:64] == W).all(axis=1)
    targeted = np.zeros_like(old)
    targeted[:64] = True
    good = found & (old | (targeted & new))
    payload = {"committed_lost": int((~good).sum()),
               "chaos": dict(cluster.chaos), "stats": cluster.stats()}
    return _cell("timeout_giveup", scheme, workload, seed, {
        "no_acks_on_dead_wire": not w.ok.any(),
        "give_ups_raised": give_ups > 0,
        "timeouts_surfaced": timeouts_seen > 0,
        "lossless_after_heal": bool(good.all()),
        "untargeted_exact": bool((found & old)[~targeted].all()
                                 if (~targeted).any() else True),
    }, payload)


# -- soak -------------------------------------------------------------------
def soak(scheme: str, workload: str, seed: int, sizes: dict,
         device: str) -> dict:
    """Long churn run: join, partition + stale acks + heal + resync,
    second join, crash, graceful leave — back-to-back on a lossy wire.
    The union of every family's invariants must hold at the end.  The
    partition window closes (resync) BEFORE the crash: overlapping a
    partition of one replica with the death of its co-replica exceeds
    the <= R-1 concurrent-failure contract for that key."""
    sizes = dict(sizes, num_ops=2 * sizes["num_ops"])
    r = sizes["num_ops"] // 8
    c = run_cluster(scheme, workload, nodes=4, replicas=2,
                    events=[("join", r, "pmJ"),
                            ("partition", 2 * r, "pm1"),
                            ("stale", 2 * r + 1, "pm1"),
                            ("heal", 3 * r, "pm1"),
                            ("resync", 4 * r, "pm1"),
                            ("join", 5 * r, "pmK"),
                            ("kill", 6 * r, "pm0"),
                            ("leave", 7 * r, "pm3")],
                    seed=seed, faults=_mild_faults(seed),
                    retry=RetryPolicy(), heartbeat_timeout=2.0,
                    grace_s=5.0, device=device, **sizes)
    checks = _fencing_checks(c)
    checks["kill_promoted"] = any(e["event"] == "failover"
                                  for e in c["events"])
    checks["rebalance_within_bound"] = c["rebalance_within_bound"]
    checks["churn_membership_settled"] = c["nodes_final"] == 4
    return _cell("soak", scheme, workload, seed, checks, c)


SCENARIOS: Dict[str, Callable[..., dict]] = {
    "storm": storm,
    "storm_mid_join": storm_mid_join,
    "storm_mid_migration": storm_mid_migration,
    "partition_fence": partition_fence,
    "partition_failover": partition_failover,
    "lag_reads": lag_reads,
    "delivery_faults": delivery_faults,
    "read_only_degrade": read_only_degrade,
    "timeout_giveup": timeout_giveup,
    "soak": soak,
}


def run_scenario(name: str, *, scheme: str = "continuity",
                 workload: str = "A", seed: int = 0,
                 profile: str = "smoke", device: str = "cuda") -> dict:
    """Run one named scenario cell; see `SCENARIOS` for the registry."""
    return SCENARIOS[name](scheme, workload, seed, dict(SIZES[profile]),
                           device)
