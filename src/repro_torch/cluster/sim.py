"""N-node YCSB cluster simulation: skewed streams, elastic membership,
mid-run failures — `rdma.sim` scaled from one server to a cluster.

Port of ``repro.cluster.sim``.  Drives a `ClusterStore` (any registered
scheme, node tables on ``device``: the card unless the caller asks for the
CPU) with YCSB mixes under a zipfian or hotspot request stream, firing
membership EVENTS at op thresholds mid-run:

    ("join",  at_op, name)   live migration in (begin -> dual-read
                             window -> cutover at the next round)
    ("leave", at_op, name)   graceful decommission
    ("kill",  at_op, name)   crash (name or "primary" = the node owning
                             the hottest key); heartbeats stop, the
                             `FailoverController` detects and promotes
    ("partition", at, name)  network partition: the node stays alive but
                             unreachable — the epoch bump fences it; the
                             monitor's suspect/grace window decides
                             whether it is promoted away or survives
    ("stale", at, name)      clients that missed the partition write
                             THROUGH the stale ex-primary (unfenced
                             acks, all of which MUST be detected)
    ("heal",  at, name)      the partition heals: reachable again but
                             fenced (replica-lag reads) until resync
    ("resync", at, name)     detect the stale acks, rebuild the shard
                             from the current primaries, re-admit

and checks the cluster invariants:

  * zero committed-op loss: every op acked before the crash is readable
    with its exact value after failover;
  * rebalance minimality: a join moves <= 1/N + 5% of resident keys;
  * fencing completeness: every injected stale ack is detected at
    resync/failover and none becomes visible in the keyspace.

The acknowledged values and the insertion order are arrays indexed by
record id (`_Acked`), so a run at the paper's record count keeps no
per-record Python objects; the payload and the random draws are the
reference's.

``python -m repro_torch.cluster.sim --smoke [--device cpu] [--json OUT]``
runs the drill: the N-node mixed-workload run with one join and one
primary-kill, PLUS the store-trace-level durability sweep
(`replication.check_replicated_durability` — fenced must be lossless,
UNFENCED must be caught losing acked ops) and the migration crash sweep.
Exit status 0 iff every invariant holds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.cluster.failover import FailoverController
from repro_torch.cluster.store import ClusterStore
from repro_torch.data import ycsb

Event = Tuple[str, int, str]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class _Acked:
    """The committed (record id -> value) map and the insertion order, as
    growable arrays: ``order[:n]`` lists acked inserts in ack order,
    ``vals[i]`` is record ``i``'s last acked value where ``has[i]``."""

    def __init__(self, capacity: int):
        capacity = max(1, capacity)
        self.vals = np.zeros((capacity, 4), np.uint32)
        self.has = np.zeros((capacity,), bool)
        self._order = np.zeros((capacity,), np.int64)
        self.n = 0
        self.max_id = -1

    @property
    def order(self) -> np.ndarray:
        return self._order[:self.n]

    def _grow(self, need_id: int, need_n: int) -> None:
        if need_id >= len(self.has):
            cap = max(need_id + 1, 2 * len(self.has))
            self.vals = np.concatenate(
                [self.vals, np.zeros((cap - len(self.has), 4), np.uint32)])
            self.has = np.concatenate(
                [self.has, np.zeros((cap - len(self.has),), bool)])
        if need_n > len(self._order):
            self._order = np.concatenate(
                [self._order, np.zeros((max(need_n, 2 * len(self._order))
                                        - len(self._order),), np.int64)])

    def set(self, ids: np.ndarray, vals: np.ndarray) -> None:
        """``acked[i] = v`` for each pair in order (the last of repeated
        ids wins, as the reference's dict assignment)."""
        if not len(ids):
            return
        self._grow(int(ids.max()), self.n)
        rev = ids[::-1]
        _, last = np.unique(rev, return_index=True)
        pick = len(ids) - 1 - last
        self.vals[ids[pick]] = vals[pick]
        self.has[ids[pick]] = True

    def append(self, ids: np.ndarray, vals: np.ndarray) -> None:
        """Acked inserts: record the values and extend the order."""
        if not len(ids):
            return
        self.set(ids, vals)
        self._grow(0, self.n + len(ids))
        self._order[self.n:self.n + len(ids)] = ids
        self.n += len(ids)
        self.max_id = max(self.max_id, int(ids.max()))

    def ids(self) -> np.ndarray:
        """Every acked record id, ascending."""
        return np.flatnonzero(self.has)


def _stream(dist: str, n: int, theta: float = 0.99,
            hot_frac: float = 0.2, hot_op_frac: float = 0.8):
    return ycsb.request_stream(dist, n, theta=theta, hot_frac=hot_frac,
                               hot_op_frac=hot_op_frac)


def _node_slots(workload: str, batch: int, num_records: int, num_ops: int,
                nodes: int, replicas: int) -> int:
    """Each node's size for its replicated share plus rebalance headroom
    (the reference's formula)."""
    from repro_torch.rdma.sim import _mix_counts
    n_read, n_upd, n_ins, n_scan, n_rmw = _mix_counts(workload, batch)
    n_logical = n_read + n_upd + n_ins + n_scan - n_rmw
    per = ((num_records + n_ins * (num_ops // max(1, n_logical)))
           * replicas / nodes)
    return int(per * 3) + 256


def run_cluster(scheme: str = "continuity", workload: str = "A", *,
                nodes: int = 4, replicas: int = 2,
                num_records: int = 1200, num_ops: int = 2400,
                batch: int = 240, dist: str = "zipf",
                theta: float = 0.99, hot_frac: float = 0.2,
                hot_op_frac: float = 0.8,
                events: Sequence[Event] = (), node_slots: Optional[int] = None,
                seed: int = 0, heartbeat_timeout: float = 5.0,
                grace_s: float = 0.0, faults=None, retry=None,
                maintenance: bool = True, resize_trigger_lf: float = 0.85,
                resize_budget: int = 2, device: str = "cuda",
                timings: Optional[Dict[str, list]] = None) -> Dict:
    """One cluster cell; deterministic given the seed (ONE explicit seed
    feeds the value stream, the request stream, the scramble, and the
    chaos injections — the returned payload echoes it so any cell can be
    replayed bit-exactly).  ``faults``/``retry`` optionally wrap every
    node's endpoint in the transport's delivery-fault injector and retry
    policy; ``grace_s`` is the monitor's partition-suspicion window.
    ``timings``, when given, collects host-clock seconds of the run's
    parts (``load``, ``round``, ``join_copy``, ``join_cutover``,
    ``failover``, ``audit``; ``peek``, the torn-update repair's pre-batch
    read of each update batch) and the count of replicas that repair
    rewrote (``torn_repaired``), without changing the payload.
    Returns the aggregate payload."""
    assert workload in ycsb.WORKLOADS, workload
    from repro_torch.rdma.sim import _mix_counts
    n_read, n_upd, n_ins, n_scan, n_rmw = _mix_counts(workload, batch)
    n_logical = n_read + n_upd + n_ins + n_scan - n_rmw

    if node_slots is None:
        node_slots = _node_slots(workload, batch, num_records, num_ops,
                                 nodes, replicas)
    cluster = ClusterStore(scheme, nodes=nodes, replicas=replicas,
                           node_slots=node_slots, faults=faults, retry=retry,
                           device=device)
    clock = _FakeClock()
    ctl = FailoverController(cluster, timeout_s=heartbeat_timeout,
                             clock=clock, grace_s=grace_s)
    tm: Dict[str, list] = timings if timings is not None else {}

    def timed(part: str, fn):
        t0 = time.perf_counter()
        out = fn()
        tm.setdefault(part, []).append(time.perf_counter() - t0)
        return out

    rng = np.random.RandomState(seed)
    acked = _Acked(num_records + n_ins * (num_ops // max(1, n_logical) + 1))

    def load(ids: np.ndarray, vals: np.ndarray,
             record: bool = False) -> np.ndarray:
        nonlocal wall_us
        res = cluster.insert(ycsb.make_key(ids), vals)
        okn = np.asarray(res.ok)
        if record:              # mid-run inserts count toward the metrics
            wall_us += res.round_us
            h_write.record_many(res.op_us[okn])
        acked.append(ids[okn], vals[okn])
        return okn

    # per-op-type latency sketches: the ONE percentile path for this
    # cell (the payload's p50/p99 AND the obs export read these buckets)
    h_read, h_write = obs.Histogram(), obs.Histogram()
    wall_us = 0.0

    def load_all():
        for lo in range(0, num_records, batch):
            ids = np.arange(lo, min(lo + batch, num_records))
            load(ids, ycsb.make_value(rng, len(ids)))
    timed("load", load_all)
    stream = _stream(dist, acked.n, theta, hot_frac, hot_op_frac)
    scramble = rng.permutation(acked.n)

    pending = sorted(events, key=lambda e: e[1])
    pending_complete_join = False
    reports: List[dict] = []
    rebalance_ok = failover_seen = True
    ops_done = step = 0
    killed: List[str] = []
    partitioned: List[str] = []

    def hottest_primary() -> str:
        order = acked.order
        hot = ycsb.make_key(np.array([order[scramble[0] % len(order)]]))
        names = cluster.directory.replica_names(hot)
        return str(names[0, 0])

    def failover_reports():
        for rep in timed("failover", ctl.tick):
            reports.append({"event": "failover", "dead": rep.dead,
                            "promoted_keys": rep.promoted_keys,
                            "recopied": rep.recopied,
                            "recovery_log_free": rep.recovery_log_free()})

    while ops_done < num_ops:
        step += 1
        t_round = time.perf_counter()
        with obs.span("cluster.round", round=step):
            clock.t += 1.0
            ctl.beat(step)
            failover_reports()
            if pending_complete_join and not cluster.migrating:
                pending_complete_join = False   # the joiner died mid-window
            if pending_complete_join:       # cutover one full round after COPY:
                rb = timed("join_cutover", cluster.complete_join)
                pending_complete_join = False  # the dual-read window was live
                rebalance_ok &= rb.within_bound
                reports.append({"event": "join", "node": rb.node,
                                "resident": rb.resident,
                                "moved_primary": rb.moved_primary,
                                "moved_frac": rb.moved_frac, "bound": rb.bound,
                                "copied": rb.copied, "cleaned": rb.cleaned,
                                "within_bound": rb.within_bound})
            while pending and pending[0][1] <= ops_done:
                kind, _, name = pending.pop(0)
                if kind == "join":
                    timed("join_copy",
                          lambda: cluster.begin_join(name, node_slots))
                    ctl.monitor.register(name)
                    pending_complete_join = True
                elif kind == "leave":
                    rb = cluster.leave(name)
                    reports.append({"event": "leave", "node": rb.node,
                                    "moved_frac": rb.moved_frac,
                                    "copied": rb.copied})
                    ctl.monitor.hosts.pop(name, None)
                elif kind == "partition":
                    name = hottest_primary() if name == "primary" else name
                    cluster.partition(name)
                    partitioned.append(name)
                    reports.append({"event": "partition", "node": name,
                                    "epoch": cluster.epoch})
                elif kind == "stale":
                    # clients that missed the partition keep writing through
                    # the stale ex-primary: divergent values on HOT keys (the
                    # worst case — if fencing leaked, the audit would read
                    # them).  None of these acks is legitimate, so none
                    # enters `acked`.
                    ranks = stream.sample(rng, 16) % len(scramble)
                    sids = acked.order[scramble[ranks] % acked.n]
                    n = cluster.stale_write(name, ycsb.make_key(sids),
                                            ycsb.make_value(rng, len(sids)))
                    reports.append({"event": "stale", "node": name,
                                    "acks_injected": n})
                elif kind == "heal":
                    cluster.heal(name)
                    reports.append({"event": "heal", "node": name})
                elif kind == "resync":
                    hr = cluster.resync(name)
                    reports.append({"event": "resync", "node": hr.node,
                                    "stale_acks_detected":
                                        hr.stale_acks_detected,
                                    "resynced": hr.resynced})
                else:
                    assert kind == "kill", kind
                    name = hottest_primary() if name == "primary" else name
                    cluster.kill(name)
                    killed.append(name)

            if n_read:
                ranks = stream.sample(rng, n_read) % acked.n
                ids = acked.order[scramble[ranks % len(scramble)]
                                  % acked.n] \
                    if workload != "D" else \
                    acked.order[acked.n - 1 - ranks]
                res = cluster.lookup(ycsb.make_key(ids))
                h_read.record_many(res.op_us[np.asarray(res.found)])
                wall_us += res.round_us
            if n_scan:
                # YCSB-E short scans: zipf-ranked start keys, uniform spans
                ranks = stream.sample(rng, n_scan) % len(scramble)
                sids = acked.order[scramble[ranks] % acked.n]
                spans = ycsb.scan_lengths(rng, n_scan)
                res = cluster.scan(ycsb.make_key(sids), spans)
                h_read.record_many(res.op_us[np.asarray(res.found)])
                wall_us += res.round_us
            if n_upd:
                # F's updates are the write half of read-modify-write: they
                # hit the keys the SAME round just read, not a fresh draw
                if n_rmw:
                    ids = ids[-n_upd:]
                else:
                    ranks = stream.sample(rng, n_upd) % len(scramble)
                    ids = acked.order[scramble[ranks] % acked.n]
                vals = ycsb.make_value(rng, n_upd)
                res = cluster.update(ycsb.make_key(ids), vals)
                okn = np.asarray(res.ok)
                acked.set(ids[okn], vals[okn])
                h_write.record_many(res.op_us[okn])
                wall_us += res.round_us
            if n_ins:
                base = acked.max_id + 1
                ids = np.arange(base, base + n_ins)
                load(ids, ycsb.make_value(rng, n_ins), record=True)
                stream = _stream(dist, acked.n, theta, hot_frac, hot_op_frac)
            if maintenance:
                # between-rounds shard growth: any shard past the trigger
                # load factor splits `resize_budget` cohorts per round while
                # the YCSB stream above keeps flowing (writes/reads route by
                # the split's cutover tokens)
                for act in cluster.maintenance_step(budget=resize_budget,
                                                    trigger_lf=resize_trigger_lf):
                    if act["action"] != "step":
                        reports.append({"event": "resize", "round": step, **act})
            ops_done += n_logical
        tm.setdefault("round", []).append(time.perf_counter() - t_round)

    # let a terminal kill drain through detection before the audit (the
    # horizon includes the suspicion grace window: a node is only
    # declared failed past timeout + grace)
    for _ in range(int(heartbeat_timeout + grace_s) + 2):
        step += 1
        clock.t += 1.0
        ctl.beat(step)
        failover_reports()
    failover_seen = (not killed
                     or any(r["event"] == "failover" for r in reports))

    # the zero-committed-loss audit: EVERY acked (id, value) must read
    # back exactly after all failures and rebalances.  Fault injection is
    # quiesced first — the audit measures durability, not delivery luck
    cluster.quiesce_faults()
    audit_ids = acked.ids()
    lost = 0

    def audit():
        nonlocal lost
        with obs.span("cluster.audit", n=len(audit_ids)):
            for lo in range(0, len(audit_ids), batch):
                ids = audit_ids[lo:lo + batch]
                res = cluster.lookup(ycsb.make_key(ids))
                good = (np.asarray(res.found)
                        & (res.values == acked.vals[ids]).all(axis=1))
                lost += int((~good).sum())
    timed("audit", audit)
    tm["torn_repaired"] = [cluster.torn_repaired]
    tm["peek"] = list(cluster.peek_seconds)

    merged = obs.Histogram()
    merged.merge(h_read)
    merged.merge(h_write)
    reg = obs.get_registry()
    reg.histogram("cluster.op_us", scheme=scheme, workload=workload,
                  op="read", seed=seed).merge(h_read)
    reg.histogram("cluster.op_us", scheme=scheme, workload=workload,
                  op="write", seed=seed).merge(h_write)
    # fold every node endpoint's wire registry into the installed one so
    # a traced run exports per-tag transport counters cluster-wide
    reg.merge(cluster.metrics_view())
    return {
        "scheme": scheme, "workload": workload, "dist": dist, "seed": seed,
        "theta": theta, "hot_frac": hot_frac, "hot_op_frac": hot_op_frac,
        "nodes_initial": nodes, "nodes_final": len(cluster.node_names()),
        "replicas": replicas, "ops": ops_done,
        "chaos": dict(cluster.chaos), "partitioned": partitioned,
        "ops_per_s": ops_done / max(wall_us, 1e-9) * 1e6,
        "p50_us": merged.percentile(50),
        "p99_us": merged.percentile(99),
        "committed": int(acked.has.sum()), "committed_lost": lost,
        "rebalance_within_bound": bool(rebalance_ok),
        "failover_detected": bool(failover_seen),
        "maintenance": dict(cluster.maintenance),
        "events": reports, "killed": killed,
        "stats": cluster.stats(),
    }


def durability_drill(scheme: str = "continuity", n_base: int = 24,
                     n_ops: int = 8, device: str = "cuda") -> Dict:
    """Store-trace-level replicated-durability sweep: the fenced
    discipline must lose ZERO acked ops over every primary-crash prefix;
    the unfenced delivery MUST be caught losing some (the negative control
    proving the checker sees real loss)."""
    from repro_torch import api
    from repro_torch.cluster.replication import check_replicated_durability
    store = api.make_store(scheme, table_slots=max(240, n_base * 10),
                           device=device)
    rng = np.random.RandomState(11)
    K = ycsb.make_key(np.arange(n_base))
    table, res = store.insert(store.create(), K,
                              ycsb.make_value(rng, n_base))
    live = K[res.ok.cpu().numpy()][:n_ops]
    fenced = check_replicated_durability(
        store, table, "update", live, ycsb.make_value(rng, len(live)),
        fenced=True)
    unfenced = check_replicated_durability(
        store, table, "update", live, ycsb.make_value(rng, len(live)),
        fenced=False)
    return {
        "scheme": scheme,
        "fenced": {"cuts": fenced.cuts, "acked": fenced.acked_total,
                   "lost_committed": fenced.lost_committed,
                   "zero_loss": fenced.zero_loss},
        "unfenced": {"cuts": unfenced.cuts, "acked": unfenced.acked_total,
                     "lost_committed": unfenced.lost_committed,
                     "loss_detected": unfenced.lost_committed > 0},
        "ok": fenced.zero_loss and unfenced.lost_committed > 0,
    }


def migration_drill(scheme: str = "continuity", n_base: int = 18,
                    n_move: int = 6, device: str = "cuda") -> Dict:
    """Migration crash sweep (the matrix cell's twin)."""
    from repro_torch import api
    from repro_torch.cluster.migration import migration_crash_sweep
    store = api.make_store(scheme, table_slots=max(240, n_base * 10),
                           device=device)
    rng = np.random.RandomState(13)
    K = ycsb.make_key(np.arange(n_base))
    V = ycsb.make_value(rng, n_base)
    src, res = store.insert(store.create(), K, V)
    okn = res.ok.cpu().numpy()
    sweep = migration_crash_sweep(store, src, store.create(),
                                  K[okn][:n_move], V[okn][:n_move])
    return {
        "scheme": scheme, "moved": sweep.moved,
        "crash_points": sweep.crash_points,
        "torn_points": sweep.torn_points,
        "violations": len(sweep.violations),
        "log_free": sweep.log_free, "ok": sweep.consistent,
    }


def smoke_kwargs(smoke: bool) -> dict:
    """The drill's sizes and events: ``--smoke`` or the default run."""
    kw = (dict(num_records=600, num_ops=1200, batch=240) if smoke
          else dict(num_records=2000, num_ops=4000, batch=400))
    kw["events"] = (("join", kw["num_ops"] // 3, "pmJ"),
                    ("kill", 2 * kw["num_ops"] // 3, "primary"))
    return kw


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scheme", default="continuity")
    p.add_argument("--workload", default="A")
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--dist", default=None, choices=("zipf", "hotspot"),
                   help="request distribution (default: zipf here, the "
                        "fan-in drill's own hotspot default under --cache)")
    p.add_argument("--seed", type=int, default=0,
                   help="the ONE seed every stream derives from (echoed "
                        "in the JSON payload for bit-exact replay)")
    p.add_argument("--device", default="cuda",
                   help="where the node tables live (default: the card)")
    p.add_argument("--smoke", action="store_true",
                   help="small sizes: run + join + primary kill + the "
                        "durability and migration drills")
    p.add_argument("--json", default=None, help="write the payload here")
    p.add_argument("--trace", default=None, metavar="BASE",
                   help="trace the run under a deterministic TickClock and "
                        "write BASE.trace.json (Perfetto-loadable) + "
                        "BASE.metrics.json, including the single-server "
                        "YCSB scheme trio so `python -m "
                        "repro_torch.obs.report BASE` prints the "
                        "continuity-vs-pfarm p50 ratio")
    p.add_argument("--cache", action="store_true",
                   help="run the client-cache fan-in drill instead "
                        "(`repro_torch.cache.fanin`): O(100) clients behind "
                        "version-stamped caches vs the uncached baseline")
    p.add_argument("--clients", type=int, default=100,
                   help="fan-in client count (only with --cache)")
    args = p.parse_args(argv)

    if args.cache:
        from repro_torch.cache import fanin
        fwd = ["--scheme", args.scheme, "--clients", str(args.clients),
               "--seed", str(args.seed), "--device", args.device]
        if args.dist is not None:
            fwd += ["--dist", args.dist]
        if args.smoke:
            fwd.append("--smoke")
        if args.json:
            fwd += ["--json", args.json]
        return fanin.main(fwd)

    kw = smoke_kwargs(args.smoke)

    def _drive():
        cell = run_cluster(args.scheme, args.workload, nodes=args.nodes,
                           replicas=args.replicas, dist=args.dist or "zipf",
                           seed=args.seed, device=args.device, **kw)
        return cell, {
            "cluster": cell,
            "durability": durability_drill(args.scheme, device=args.device),
            "migration": migration_drill(args.scheme, device=args.device),
        }

    if args.trace:
        from repro_torch.rdma.sim import run_ycsb
        with obs.scope(obs.Tracer(obs.TickClock())) as (tracer, reg):
            cell, payload = _drive()
            # the report's headline latency ratio wants the single-server
            # YCSB scheme trio in the SAME export (e2e.op_us histograms).
            # The trio runs at run_ycsb's FULL default sizes even under
            # --smoke: small tables let the probe baselines hit on their
            # first probe, which inverts the p50 ordering the report gates
            for sch in ("continuity", "level", "pfarm"):
                for wl in ("A", "C"):
                    with obs.span("e2e.cell", scheme=sch, workload=wl):
                        run_ycsb(sch, wl, seed=args.seed, device=args.device)
            tpath, mpath = obs.write_export(
                args.trace, tracer, reg,
                meta={"scheme": args.scheme, "workload": args.workload,
                      "seed": args.seed,
                      "profile": "smoke" if args.smoke else "full"})
        payload["obs_export"] = {"trace": tpath, "metrics": mpath}
        print(f"obs export: {tpath} + {mpath}")
    else:
        cell, payload = _drive()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True, default=str)

    print(f"cluster {args.scheme}/{args.workload} x{args.nodes} "
          f"(R={args.replicas}, {args.dist or 'zipf'}, seed={args.seed}): "
          f"{cell['ops_per_s']:.0f} ops/s p50={cell['p50_us']:.2f}us "
          f"p99={cell['p99_us']:.2f}us nodes {cell['nodes_initial']}->"
          f"{cell['nodes_final']}")
    for r in cell["events"]:
        print(f"  event: {r}")
    print(f"committed={cell['committed']} lost={cell['committed_lost']} "
          f"rebalance_within_bound={cell['rebalance_within_bound']} "
          f"failover_detected={cell['failover_detected']}")
    d, m = payload["durability"], payload["migration"]
    print(f"durability drill: fenced lost={d['fenced']['lost_committed']} "
          f"over {d['fenced']['cuts']} cuts; unfenced lost="
          f"{d['unfenced']['lost_committed']} (must be >0) -> "
          f"{'PASS' if d['ok'] else 'FAIL'}")
    print(f"migration drill: {m['crash_points']} crash points "
          f"({m['torn_points']} torn), {m['violations']} violations, "
          f"log_free={m['log_free']} -> {'PASS' if m['ok'] else 'FAIL'}")

    bad = []
    if cell["committed_lost"]:
        bad.append("committed ops lost across failover")
    if not cell["rebalance_within_bound"]:
        bad.append("join moved more than 1/N + 5% of resident keys")
    if not cell["failover_detected"]:
        bad.append("kill was never detected/promoted")
    if not d["ok"]:
        bad.append("replicated-durability drill failed")
    if not m["ok"]:
        bad.append("migration crash sweep failed")
    for b in bad:
        print(f"FAIL: {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
