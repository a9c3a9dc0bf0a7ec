"""`ClusterStore`: one keyspace served by N PM nodes, any registered scheme.

Port of ``repro.cluster.store``.  Every node runs ONE `repro_torch.api`
store (any registered scheme) as its PM shard image, with its table on the
cluster's device (``cuda`` unless the caller asks for the CPU); the
rendezvous `Directory` routes every key to an R-node replica set, and each
node owns a simulated RNIC endpoint (`rdma.RemoteMemory`) that prices what
the cluster puts on its wire.

Semantics (the reference's):

  * **writes** apply to every live replica-set member and post the
    fenced replication `VerbPlan` (synthesized from the member's own
    `CostLedger`, exactly like `rdma.sim`) to that member's endpoint.
    An op is acked iff every live member committed it; per-op latency
    is the chain sum (primary applies, forwards, acks after the last
    replica's commit fence — the discipline
    `cluster.replication.check_replicated_durability` proves lossless).
  * **reads** route to the key's primary (first SERVING member — a dead,
    not-yet-promoted primary degrades to replica reads instead of
    failing) and post the scheme's exact lookup verb plan.  During a
    migration window reads run DUAL: misses retry against the other
    directory's owner (`cluster.migration` proves the union is always
    correct).
  * **join/leave** are live migrations: copy (from old primaries only —
    one source per key), ONE host-atomic directory cutover (the PM
    token twin is swept in `migration.py`), then cleanup.  The
    `RebalanceReport` carries the moved-key fraction bounded at 1/N + 5%.
  * **kill/failover**: a killed node goes silent (its image frozen: no
    path writes a node that is not serving); `failover` removes it from
    the directory — rendezvous re-ranks the surviving replicas to primary
    for exactly its keys — runs every survivor's restart procedure
    (indicator-based for continuity), and re-replicates to restore R.

Where the data are: keys, routing (`Directory.replica_sets_t`, node names
as cluster-wide ids) and the bulk moves of join, leave, cleanup, resync
and failover stay on the device; per-op results of the public calls come
back as numpy arrays, as the reference's.  `_distinct_resident` merges the
serving nodes' items with sorts (`core.words.row_groups`), never a
per-key host loop.

Batch sub-routing pads per-node sub-batches to `PAD_QUANTUM` (padded rows
are masked writes / ignored reads, so ledgers and plans stay row-for-row
the reference's) and runs them through the store in slices of at most
`CALL_ROWS` rows.  Lookups are per key, so slicing changes nothing; a
sliced insert equals the single batch while the extension pool does not
run out inside a slice (as `continuity.resize`'s chunks).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import api, obs
from repro_torch.cluster.directory import Directory
from repro_torch.cluster.failover import FailoverReport
from repro_torch.core.words import as_words, resolve_device, row_groups
from repro_torch.rdma import verbs as rv
from repro_torch.rdma.sim import post_ledger_writes
from repro_torch.rdma.transport import (DeliveryTimeout, FaultInjector,
                                        LinkModel, RemoteMemory, RetryPolicy)

U32 = np.uint32
PAD_QUANTUM = 64
# rows of one store call: a padded sub-batch runs in slices of this size
CALL_ROWS = 1 << 22

# per-maintenance-step stall SLO (us) when the caller does not pass one:
# a step is priced at cohorts_moved x LinkModel.cohort_move_us(row), and a
# step whose priced stall exceeds the SLO counts as one burn
# (maintenance["slo_burns"] / the maintenance.slo_burn counter)
DEFAULT_STEP_SLO_US = 500.0


@dataclasses.dataclass
class _Node:
    name: str
    store: Any
    table: Any
    mem: Optional[RemoteMemory]
    alive: bool = True
    reachable: bool = True      # False while partitioned (alive, but cut off)
    epoch: int = 0              # directory epoch the node last joined/synced
    # in-flight incremental resize (an api.ResizeState): while set, every
    # read/write/stamp on this node routes through the split's per-cohort
    # cutover tokens; `maintenance_step` advances and eventually clears it
    resize: Optional[Any] = None
    # (keys, vals, epoch) writes a stale ex-primary acked while partitioned
    # (device word tensors) — the fencing machinery must detect and
    # discard EVERY one of these
    stale_log: List[Tuple[torch.Tensor, torch.Tensor, int]] = \
        dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class HealReport:
    """One partition heal + resync: the fencing-epoch bookkeeping."""

    node: str
    stale_acks_detected: int    # logged stale-epoch acks fenced out
    resynced: int               # keys re-copied from the current primaries


@dataclasses.dataclass(frozen=True)
class _Migration:
    new_dir: Directory
    resident: int
    copied: int
    moved_primary: int


class ClusterWriteResult(NamedTuple):
    ok: np.ndarray          # (B,) acked per op (all live members committed)
    op_us: np.ndarray       # (B,) simulated chain latency per acked op
    round_us: float         # wall time of the round (busiest node)


class ClusterReadResult(NamedTuple):
    values: np.ndarray      # (B, 4) uint32
    found: np.ndarray       # (B,) bool
    op_us: np.ndarray       # (B,) unloaded per-op latency
    round_us: float


class ClusterStampResult(NamedTuple):
    """One stamp-validation round (`ClusterStore.version_read`)."""

    stamps: np.ndarray      # (B, S) int64 — scheme stamp rows; -1 = unresolved
    source: np.ndarray      # (B,) object — answering node name ("" = none)
    resolved: np.ndarray    # (B,) bool — a serving member answered
    op_us: np.ndarray       # (B,) unloaded per-op latency
    round_us: float


class ClusterStampedRead(NamedTuple):
    """A cache-fill read (`ClusterStore.lookup_stamped`): lookup answers
    plus the answering node's version stamps from the same routing."""

    values: np.ndarray      # (B, 4) uint32
    found: np.ndarray       # (B,) bool
    stamps: np.ndarray      # (B, S) int64 — -1 rows carry no stamp
    source: np.ndarray      # (B,) object — answering node name ("" = none)
    op_us: np.ndarray       # (B,) unloaded per-op latency
    round_us: float


@dataclasses.dataclass(frozen=True)
class RebalanceReport:
    """One join/leave rebalance; ``moved_frac <= bound`` is the gate."""

    kind: str               # join | leave
    node: str
    resident: int           # distinct keys resident before the change
    moved_primary: int      # keys whose PRIMARY changed
    copied: int             # replica copies shipped
    cleaned: int            # stale copies deleted at cleanup
    bound: float            # 1/N + 5% for the new membership

    @property
    def moved_frac(self) -> float:
        return self.moved_primary / max(1, self.resident)

    @property
    def within_bound(self) -> bool:
        return self.moved_frac <= self.bound


class _Lookup(NamedTuple):
    """A padded sub-batch's lookup, its slices joined: device values and
    found flags of the real rows, and the plan of every padded row."""

    values: torch.Tensor
    found: torch.Tensor
    plan: Optional[rv.VerbPlan]


def _pad(n: int) -> int:
    return -(-max(n, 1) // PAD_QUANTUM) * PAD_QUANTUM


def _slice_plan(plan, n: int):
    """First ``n`` rows of a padded `VerbPlan`: plan rows are per-op and
    independent, so the slice is a legal plan on its own."""
    return rv.VerbPlan(*(leaf[:n] for leaf in plan))


def _host(words: torch.Tensor) -> np.ndarray:
    """Device word rows -> the reference's uint32 numpy rows."""
    return words.cpu().numpy().view(U32)


def _stamps(st: torch.Tensor) -> torch.Tensor:
    """Stamp words as the reference's int64 of uint32 values."""
    return st.to(torch.int64) & 0xFFFFFFFF


def _rows_in(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(len(a),) bool: each row of ``a`` occurs among the rows of ``b``."""
    if not len(a) or not len(b):
        return torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    gid, _ = row_groups(torch.cat([b, a]))
    has_b = torch.zeros(int(gid.max()) + 1, dtype=torch.bool, device=a.device)
    has_b[gid[:b.shape[0]]] = True
    return has_b[gid[b.shape[0]:]]


class ClusterStore:
    """Sharded, replicated KV store over N simulated PM nodes."""

    def __init__(self, scheme: str = "continuity", nodes: int = 4,
                 replicas: int = 2, node_slots: int = 2048,
                 policy: Optional[api.ExecPolicy] = None,
                 link: Optional[LinkModel] = None,
                 faults: Optional[FaultInjector] = None,
                 retry: Optional[RetryPolicy] = None,
                 device: str = "cuda"):
        names = tuple(f"pm{i}" for i in range(nodes))
        self.scheme = scheme
        self.device = resolve_device(device)
        self._node_slots = node_slots
        self._policy = policy or api.ExecPolicy(transport="sim")
        self._link = link
        self._faults = faults       # shared injector: one seeded draw stream
        self._retry = retry
        self.epoch = 0              # the directory/fencing epoch: bumped on
        #                             every membership change and partition
        self.directory = Directory(names, replicas=replicas)
        self._ids: Dict[str, int] = {}   # node name -> cluster-wide id
        self._nodes: Dict[str, _Node] = {n: self._make_node(n)
                                         for n in names}
        self._mig: Optional[_Migration] = None
        self.chaos = {"stale_acks_injected": 0, "stale_acks_detected": 0,
                      "writes_rejected_read_only": 0, "lag_read_redirects": 0,
                      "write_timeouts": 0, "read_timeouts": 0}
        self.maintenance = {"resizes_begun": 0, "steps": 0,
                            "cohorts_moved": 0, "cutovers": 0,
                            "blocking_resizes": 0, "slo_burns": 0}
        self.torn_repaired = 0      # replicas `_untear` rewrote
        self.peek_seconds: List[float] = []   # host clock of each `_peek`

    # -- membership plumbing ------------------------------------------------
    def _make_node(self, name: str, slots: Optional[int] = None) -> _Node:
        store = api.make_store(self.scheme,
                               table_slots=slots or self._node_slots,
                               policy=self._policy, device=str(self.device))
        self._id(name)
        return _Node(name, store, store.create(),
                     RemoteMemory.from_policy(store.policy, self._link,
                                              faults=self._faults,
                                              retry=self._retry),
                     epoch=self.epoch)

    def _id(self, name: str) -> int:
        return self._ids.setdefault(name, len(self._ids))

    def _sets(self, d: Directory, keys: torch.Tensor) -> torch.Tensor:
        """(B, R) replica sets of device word keys as cluster-wide node
        ids (stable across directories, unlike `Directory` indices)."""
        ids = torch.tensor([self._id(n) for n in d.nodes], dtype=torch.int64,
                           device=self.device)
        return ids[d.replica_sets_t(keys)]

    def _owned(self, d: Directory, keys: torch.Tensor,
               name: str) -> torch.Tensor:
        """`Directory.owned_mask` (role ``any``) on the device."""
        return (self._sets(d, keys) == self._id(name)).any(dim=1)

    def _words(self, x) -> torch.Tensor:
        return as_words(x, 4, self.device)

    def node_names(self) -> Tuple[str, ...]:
        return tuple(self._nodes)

    def is_alive(self, name: str) -> bool:
        return name in self._nodes and self._nodes[name].alive

    def is_reachable(self, name: str) -> bool:
        return name in self._nodes and self._nodes[name].reachable

    def _serving(self, node: _Node) -> bool:
        """A node serves cluster traffic iff it is alive, reachable, and
        CURRENT-EPOCH: a healed-but-not-yet-resynced node holds an old
        epoch token, so routing fences it out until `resync` (its image
        may carry stale-ack divergence)."""
        return node.alive and node.reachable and node.epoch == self.epoch

    def _name_serving(self, name: str) -> bool:
        return name in self._nodes and self._serving(self._nodes[name])

    def _name_lagging(self, name: str) -> bool:
        """Healed but not yet resynced: reachable, holding an old epoch
        token.  Readable-looking but fenced — reads redirect past it."""
        n = self._nodes.get(name)
        return (n is not None and n.alive and n.reachable
                and n.epoch < self.epoch)

    def serving_names(self) -> Tuple[str, ...]:
        return tuple(n.name for n in self._nodes.values()
                     if self._serving(n))

    @property
    def read_only(self) -> bool:
        """Quorum-loss degradation: with fewer serving nodes than the
        replication factor the cluster cannot place a full replica set,
        so it stops acking writes (reads keep flowing) instead of
        acking under-replicated data it could later lose."""
        return len(self.serving_names()) < self.directory.replicas

    @property
    def migrating(self) -> bool:
        """True while a begin_join window is open (a mid-window failover
        of the joiner itself closes it — see `failover`)."""
        return self._mig is not None

    def node(self, name: str) -> _Node:
        return self._nodes[name]

    def _bump_epoch(self) -> None:
        """Advance the fencing epoch and hand the new token to every node
        the coordinator can still reach.  A partitioned node keeps its
        old epoch — the fence: when it heals, routing refuses it and its
        stale-epoch acks are detected and discarded at `resync`."""
        cur = self.epoch
        self.epoch += 1
        for node in self._nodes.values():
            # only CURRENT nodes get the new token: a healed-but-unsynced
            # node (epoch already behind) must stay fenced through
            # unrelated membership churn until its `resync` runs
            if node.alive and node.reachable and node.epoch == cur:
                node.epoch = self.epoch
        obs.event("cluster.epoch_bump", epoch=self.epoch)

    def _resident(self, node: _Node) -> Tuple[torch.Tensor, torch.Tensor]:
        """(K, V) device words of every live item on the node."""
        keys, vals, live = node.store._extract(node.table)
        K, V = keys[live], vals[live]
        if node.resize is not None:
            # mid-split the shard's items are PARTITIONED across the two
            # tables (each cohort's source copies are deleted as its token
            # flips, and between maintenance steps no cohort is half-moved),
            # so residency is the plain union of both images
            rs = node.resize
            k2, v2, l2 = rs.new_store._extract(rs.new_table)
            K, V = torch.cat([K, k2[l2]]), torch.cat([V, v2[l2]])
        return K, V

    def _distinct_resident(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(K, V) device words of every distinct key on any SERVING node,
        in first-occurrence order over the serving nodes in node order,
        each key's value from its highest-ranked replica-set member (ties
        to the copy seen first).  Partitioned or stale-epoch images are
        excluded (their divergence must never become authoritative), and
        a leftover copy on a node that lost ownership (un-cleaned after
        churn — it stops receiving updates the moment it leaves the set)
        must never outrank the current owners' copy."""
        parts_k, parts_v, ranks = [], [], []
        r = min(self.directory.replicas, len(self.directory.nodes))
        for node in self._nodes.values():
            if not self._serving(node):
                continue
            K, V = self._resident(node)
            if not len(K):
                continue
            member = self._sets(self.directory, K) == self._id(node.name)
            ranks.append(torch.where(member.any(dim=1),
                                     member.to(torch.int8).argmax(dim=1),
                                     r + 1))
            parts_k.append(K)
            parts_v.append(V)
        if not parts_k:
            z = torch.zeros((0, 4), dtype=torch.int32, device=self.device)
            return z, z.clone()
        K, V, rank = torch.cat(parts_k), torch.cat(parts_v), torch.cat(ranks)
        n = K.shape[0]
        gid, first = row_groups(K)
        G = int(first.sum())
        # per key: the lowest (rank, position) — the copy the reference's
        # dict keeps — and the position it first occurs at
        pos = torch.arange(n, device=self.device)
        best = torch.full((G,), n * (r + 2), dtype=torch.int64,
                          device=self.device)
        best.scatter_reduce_(0, gid, rank * n + pos, "amin")
        at = torch.empty(G, dtype=torch.int64, device=self.device)
        at[gid[first]] = pos[first]
        order = torch.argsort(at)
        return K[at[order]], V[(best % n)[order]]

    # -- padded per-node sub-batches ---------------------------------------
    def _padded_write(self, op: str, node: _Node, keys: torch.Tensor,
                      vals: Optional[torch.Tensor]):
        """``(ok, ledger)``: ``ok`` the (n,) device flags of the real rows,
        ``ledger`` the `CostLedger` of the padded batch.  A dead node's
        image is frozen: no path writes it."""
        assert node.alive, f"write to the dead node {node.name}"
        n = keys.shape[0]
        P = _pad(n)
        pk = torch.zeros((P, 4), dtype=torch.int32, device=self.device)
        pk[:n] = keys
        mask = torch.zeros((P,), dtype=torch.bool, device=self.device)
        mask[:n] = True
        pv = None
        if vals is not None:
            pv = torch.zeros((P, 4), dtype=torch.int32, device=self.device)
            pv[:n] = vals
        oks, ledger = [], None
        for s in range(0, P, CALL_ROWS):
            k, m = pk[s:s + CALL_ROWS], mask[s:s + CALL_ROWS]
            v = None if pv is None else pv[s:s + CALL_ROWS]
            if node.resize is not None:
                # in-flight split: the store routes each key to the table
                # its cohort's cutover token owns (insert-during-split
                # stays lossless and duplicate-free)
                node.resize, res = node.store.resize_write(
                    node.resize, op, k, v, m)
                node.table = node.resize.table
            elif v is None:
                node.table, res = getattr(node.store, op)(node.table, k, m)
            else:
                node.table, res = getattr(node.store, op)(node.table, k, v, m)
            oks.append(res.ok)
            ledger = res.ledger if ledger is None else ledger.merge(res.ledger)
        return torch.cat(oks)[:n], ledger

    def _padded_lookup(self, node: _Node, keys: torch.Tensor) -> _Lookup:
        n = keys.shape[0]
        pk = torch.zeros((_pad(n), 4), dtype=torch.int32, device=self.device)
        pk[:n] = keys
        vals, found, plans = [], [], []
        for s in range(0, pk.shape[0], CALL_ROWS):
            k = pk[s:s + CALL_ROWS]
            if node.resize is not None:
                # dual-read during the node's split window, resolved
                # per-pair by cutover token
                res = node.store.resize_lookup(node.resize, k)
            else:
                res = node.store.lookup(node.table, k)
            vals.append(res.values)
            found.append(res.ok)
            plans.append(res.plan)
        plan = (None if plans[0] is None else
                rv.VerbPlan(*(torch.cat(f) for f in zip(*plans))))
        return _Lookup(torch.cat(vals)[:n], torch.cat(found)[:n], plan)

    # -- writes -------------------------------------------------------------
    def insert(self, keys, vals) -> ClusterWriteResult:
        return self._write("insert", keys, vals)

    def update(self, keys, vals) -> ClusterWriteResult:
        return self._write("update", keys, vals)

    def delete(self, keys) -> ClusterWriteResult:
        return self._write("delete", keys, None)

    def _write(self, op: str, keys, vals) -> ClusterWriteResult:
        with obs.span("cluster.write", op=op):
            return self._write_impl(op, keys, vals)

    def _write_impl(self, op: str, keys, vals) -> ClusterWriteResult:
        keys = self._words(keys)
        B = keys.shape[0]
        if self.read_only:
            # quorum loss: refuse the whole batch rather than ack data the
            # cluster cannot place on a full replica set
            self.chaos["writes_rejected_read_only"] += B
            obs.event("cluster.write_rejected_read_only", n=B)
            return ClusterWriteResult(np.zeros((B,), bool),
                                      np.zeros((B,)), 0.0)
        vals = None if vals is None else self._words(vals)
        ok = np.ones((B,), bool)
        touched = np.zeros((B,), bool)
        applied = np.zeros((B,), bool)
        refused = np.zeros((B,), bool)
        lat = np.zeros((B,))
        round_us = 0.0
        dirs = [self.directory] + ([self._mig.new_dir] if self._mig else [])
        # one routing pass per directory (not per node): the weight
        # matrix is the cluster's hottest computation
        sets_by_dir = [self._sets(d, keys) for d in dirs]
        # an update needs a free slot in its segment, which one member may
        # lack while another has it: the pre-batch values let a refused
        # update be taken back where it landed (`_untear`)
        prev = None
        if op == "update":
            t0 = time.perf_counter()
            prev = self._peek(keys)
            self.peek_seconds.append(time.perf_counter() - t0)
        for node in list(self._nodes.values()):
            if not self._serving(node):
                continue
            m = torch.zeros((B,), dtype=torch.bool, device=self.device)
            for d, sets in zip(dirs, sets_by_dir):
                if node.name in d.nodes:
                    m |= (sets == self._id(node.name)).any(dim=1)
            mh = m.cpu().numpy()
            if not mh.any():
                continue
            okd, ledger = self._padded_write(
                op, node, keys[m], None if vals is None else vals[m])
            okn = okd.cpu().numpy()
            ok[mh] &= okn
            touched |= mh
            applied[np.flatnonzero(mh)[okn]] = True
            refused[np.flatnonzero(mh)[~okn]] = True
            if node.mem is not None:
                try:
                    comp = post_ledger_writes(node.mem, int(okn.sum()),
                                              int(ledger.pm_writes))
                except DeliveryTimeout:
                    # the retry budget drained before this member's fenced
                    # round completed: the member's ops are NOT acked (the
                    # client never saw the commit), which keeps the
                    # zero-committed-loss invariant trivially true for them
                    self.chaos["write_timeouts"] += 1
                    obs.event("cluster.write_timeout", node=node.name)
                    ok[mh] = False
                    continue
                if comp is not None:
                    lat[np.flatnonzero(mh)[okn]] += comp.op_us  # chain sum
                    round_us = max(round_us, comp.batch_us)
        ok &= touched           # no serving member -> not acked
        if prev is not None and (applied & refused).any():
            self._untear(keys, vals, ok, applied & refused, prev, dirs)
        return ClusterWriteResult(ok, lat, round_us)

    def _peek(self, keys: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """(values, found) host arrays of each key on its first serving
        member of the current directory, read without a post: no wire
        traffic, no counters."""
        values = np.zeros((keys.shape[0], 4), U32)
        found = np.zeros((keys.shape[0],), bool)
        d = self.directory
        _, has, _, target = self._route(d, keys)
        for i in np.unique(target[has]):
            m = has & (target == i)
            res = self._padded_lookup(self._nodes[d.nodes[i]],
                                      keys[torch.from_numpy(m).to(
                                          self.device)])
            values[m] = _host(res.values)
            found[m] = res.found.cpu().numpy()
        return values, found

    def _untear(self, keys, vals, ok, torn, prev, dirs) -> None:
        """Repair of a torn update (a deliberate divergence from the
        reference, which leaves it): some member refused an op another
        applied, so the op is not acked but one replica shows its value.
        Every serving member of each torn key's replica set gets the key's
        last acked value of this batch, or its pre-batch value where no op
        on the key was acked: replicas agree again and an un-acked update
        stays invisible.  The repairs are posted like any write;
        ``torn_repaired`` counts the replicas rewritten."""
        kh, vh = _host(keys), _host(vals)
        fix_k, fix_v = [], []
        for k in np.unique(kh[torn], axis=0):
            ops = np.flatnonzero((kh == k).all(axis=1))
            done = ops[ok[ops]]
            if len(done):
                fix_v.append(vh[done[-1]])
            elif prev[1][ops[0]]:
                fix_v.append(prev[0][ops[0]])
            else:
                continue
            fix_k.append(k)
        if not fix_k:
            return
        K = self._words(np.stack(fix_k))
        V = self._words(np.stack(fix_v))
        sets = [(d, self._sets(d, K)) for d in dirs]
        for node in list(self._nodes.values()):
            if not self._serving(node):
                continue
            mine = torch.zeros(K.shape[0], dtype=torch.bool,
                               device=self.device)
            for d, s in sets:
                if node.name in d.nodes:
                    mine |= (s == self._id(node.name)).any(dim=1)
            if not bool(mine.any()):
                continue
            res = self._padded_lookup(node, K[mine])
            off = res.found & (res.values != V[mine]).any(dim=1)
            if not bool(off.any()):
                continue
            n, pm = self._overwrite(node, K[mine][off], V[mine][off])
            self.torn_repaired += n
            obs.event("cluster.torn_update_repaired", node=node.name, n=n)
            if node.mem is not None:
                try:
                    post_ledger_writes(node.mem, n, pm)
                except DeliveryTimeout:
                    # the repair is in the member's table; only its fenced
                    # round's pricing gave up
                    self.chaos["write_timeouts"] += 1
                    obs.event("cluster.write_timeout", node=node.name)

    def _overwrite(self, node: _Node, K: torch.Tensor,
                   V: torch.Tensor) -> Tuple[int, int]:
        """Set resident keys to new values on one node: an update, and for
        the keys it refuses (no free slot in their segment) a delete and
        an insert, which may take an extension group or the stash.  The
        reference updates only, and keeps the old value where refused.
        Returns (keys set, PM writes)."""
        okd, ledger = self._padded_write("update", node, K, V)
        n, pm = int(okd.sum()), int(ledger.pm_writes)
        if not bool(okd.all()):
            _, l1 = self._padded_write("delete", node, K[~okd], None)
            okd, l2 = self._padded_write("insert", node, K[~okd], V[~okd])
            n += int(okd.sum())
            pm += int(l1.pm_writes) + int(l2.pm_writes)
        return n, pm

    # -- reads --------------------------------------------------------------
    def lookup(self, keys) -> ClusterReadResult:
        with obs.span("cluster.read"):
            return self._lookup_impl(keys)

    def _lookup_impl(self, keys) -> ClusterReadResult:
        keys = self._words(keys)
        B = keys.shape[0]
        values = np.zeros((B, 4), U32)
        found = np.zeros((B,), bool)
        lat = np.zeros((B,))
        round_us = 0.0
        round_us = max(round_us, self._lookup_via(
            self.directory, keys, np.ones((B,), bool), values, found, lat))
        if self._mig is not None and not found.all():
            # dual-read window: misses retry on the new directory's owner
            round_us = max(round_us, self._lookup_via(
                self._mig.new_dir, keys, ~found, values, found, lat))
        return ClusterReadResult(values, found, lat, round_us)

    def _route(self, d: Directory, keys: torch.Tensor):
        """``(sets, has, first, target)`` host arrays: each key's replica
        set (indices into ``d.nodes``), whether a member serves, the rank
        of its first serving member, and that member's index (-1 when
        none).  ``d.nodes`` is sorted, so ascending targets visit the
        nodes in the reference's (name-sorted) order."""
        sets = d.replica_sets_t(keys).cpu().numpy()
        serving = np.array([self._name_serving(n) for n in d.nodes],
                           bool)[sets]
        has = serving.any(axis=1)
        first = np.argmax(serving, axis=1)
        target = np.where(has, sets[np.arange(len(first)), first], -1)
        return sets, has, first, target

    def _lookup_via(self, d: Directory, keys, mask, values, found,
                    lat) -> float:
        # serve from the first SERVING member: a dead, partitioned, or
        # fenced (lagging) primary degrades to replica reads until
        # failover promotes / resync re-admits it
        sets, has, first, target = self._route(d, keys)
        # a healed-but-lagging replica ranked ahead of the member chosen
        # forces a redirect — the replica-lag read path the chaos matrix
        # measures (stale images must never serve)
        lagging = np.array([self._name_lagging(n) for n in d.nodes],
                           bool)[sets]
        rank = np.arange(sets.shape[1])[None, :]
        self.chaos["lag_read_redirects"] += int(
            (mask[:, None] & has[:, None] & lagging
             & (rank < first[:, None])).any(axis=1).sum())
        round_us = 0.0
        for i in np.unique(target[mask & has]):
            name = d.nodes[i]
            node = self._nodes[name]
            m = mask & has & (target == i)
            res = self._padded_lookup(node, keys[torch.from_numpy(m).to(
                self.device)])
            vs, fs = _host(res.values), res.found.cpu().numpy()
            if node.mem is not None and res.plan is not None:
                try:
                    comp = node.mem.post(res.plan)
                except DeliveryTimeout:
                    # delivery gave up: the client saw nothing — these ops
                    # stay unresolved (a dual-read window may still retry
                    # them on the other directory's owner)
                    self.chaos["read_timeouts"] += 1
                    obs.event("cluster.read_timeout", node=name)
                    continue
                lat[m] = np.maximum(lat[m],
                                    comp.op_us[: int(m.sum())])
                round_us = max(round_us, comp.batch_us)
            values[m] = np.where(fs[:, None], vs, values[m])
            found[m] |= fs
        return round_us

    # -- cache-validation reads ---------------------------------------------
    # Version stamps are ENDPOINT-LOCAL: replica op histories legitimately
    # diverge after a resync (reconciliation replays different ops than the
    # originals), so a stamp is only comparable against the node that
    # produced it.  The answering node's name travels with every stamp;
    # a cache treats a different answerer — or an unresolved row — as a
    # failed validation and falls back to a full read.

    def _route_serving(self, keys):
        """``[(name, mask)]`` per answering node, in the reference's
        order: `_lookup_via`'s first-serving-member rule over the current
        directory, without the migration dual-read retry."""
        d = self.directory
        _, has, _, target = self._route(d, keys)
        return [(d.nodes[i], has & (target == i))
                for i in np.unique(target[has])]

    def _padded_stamp(self, node: _Node, keys: torch.Tensor):
        """(stamps, plan, fresh).  ``fresh=False`` while the node is mid-
        split: a moved cohort's mutations bump the GROWN table's pair
        word, so a stamp against the draining source word would validate
        stale cache rows forever.  Unresolved stamps cost a cache a full
        read per hot key for the window and nothing in safety."""
        n = keys.shape[0]
        if node.resize is not None:
            return np.full((n, 2), -1, np.int64), None, False
        pk = torch.zeros((_pad(n), 4), dtype=torch.int32, device=self.device)
        pk[:n] = keys
        st = _stamps(node.store.version_stamp(node.table, pk)).cpu().numpy()
        plan = node.store.version_read_plan(node.table, pk)
        # post only the REAL rows: validation is priced per key actually
        # checked, never per pad lane
        return st[:n], _slice_plan(plan, n), True

    def lookup_stamped(self, keys) -> ClusterStampedRead:
        """Cache-fill read: one routed lookup whose answers also carry the
        answering node's version stamps.  For continuity the stamp word
        lies INSIDE the segment the lookup already fetched, so the fill
        stamp is free on the wire; the post is tagged ``"fill"``.

        Live-migration windows need no special case: a join's COPY phase
        only ADDS copies, so the OLD directory's serving members (the
        routing below) hold every key, and `_write` commits bump BOTH
        directories' member sets."""
        with obs.span("cache.fill"):
            return self._lookup_stamped_impl(keys)

    def _lookup_stamped_impl(self, keys) -> ClusterStampedRead:
        keys = self._words(keys)
        B = keys.shape[0]
        src = np.full((B,), "", object)
        values = np.zeros((B, 4), U32)
        found = np.zeros((B,), bool)
        lat = np.zeros((B,))
        stamps = None
        round_us = 0.0
        for name, m in self._route_serving(keys):
            node = self._nodes[name]
            km = keys[torch.from_numpy(m).to(self.device)]
            res = self._padded_lookup(node, km)
            vs, fs = _host(res.values), res.found.cpu().numpy()
            st, _, fresh = self._padded_stamp(node, km)
            if stamps is None:
                stamps = np.full((B, st.shape[1]), -1, np.int64)
            if node.mem is not None and res.plan is not None:
                try:
                    comp = node.mem.post(_slice_plan(res.plan, int(m.sum())),
                                         tag="fill")
                except DeliveryTimeout:
                    self.chaos["read_timeouts"] += 1
                    continue
                lat[m] = np.maximum(lat[m], comp.op_us[: int(m.sum())])
                round_us = max(round_us, comp.batch_us)
            values[m] = np.where(fs[:, None], vs, values[m])
            found[m] |= fs
            stamps[m] = st
            if fresh:               # a mid-split answer is uncacheable
                src[m] = name
        if stamps is None:
            stamps = np.full((B, 1), -1, np.int64)
        return ClusterStampedRead(values, found, stamps, src, lat, round_us)

    def version_read(self, keys) -> ClusterStampResult:
        """Stamp-validation round: the scheme's `version_read_plan` —
        continuity: ONE depth-0 8-byte indicator-word READ per key —
        posted to each key's serving member (the OLD directory during a
        migration window, whose members stay write-current — see
        `lookup_stamped`), tagged ``"validate"``.  Keys with no serving
        member and delivery-timed-out sub-batches report unresolved;
        callers MUST treat unresolved as a failed validation (miss),
        never a hit."""
        with obs.span("cache.validate"):
            return self._version_read_impl(keys)

    def _version_read_impl(self, keys) -> ClusterStampResult:
        keys = self._words(keys)
        B = keys.shape[0]
        lat = np.zeros((B,))
        src = np.full((B,), "", object)
        resolved = np.zeros((B,), bool)
        stamps = None
        round_us = 0.0
        for name, m in self._route_serving(keys):
            node = self._nodes[name]
            st, plan, fresh = self._padded_stamp(
                node, keys[torch.from_numpy(m).to(self.device)])
            if stamps is None:
                stamps = np.full((B, st.shape[1]), -1, np.int64)
            if node.mem is not None and plan is not None:
                try:
                    comp = node.mem.post(plan, tag="validate")
                except DeliveryTimeout:
                    self.chaos["read_timeouts"] += 1
                    continue
                lat[m] = comp.op_us[: int(m.sum())]
                round_us = max(round_us, comp.batch_us)
            stamps[m] = st
            src[m] = name
            resolved[m] = fresh
        if stamps is None:
            stamps = np.full((B, 1), -1, np.int64)
        return ClusterStampResult(stamps, src, resolved, lat, round_us)

    def scan(self, keys, spans) -> ClusterReadResult:
        """YCSB-E short scans: route each scan's START key to its serving
        primary and post the scheme's multi-record scan plan (continuity:
        ONE contiguous multi-row READ; the probe baselines: one scattered
        READ per record).  Rendezvous hashing randomizes placement, so a
        scan is the contiguous PM range around the start record on its
        owner — it never spans shards.  ``found`` reports the start
        record resolving; the fetched range rides in the plan's bytes."""
        with obs.span("cluster.scan"):
            return self._scan_impl(keys, spans)

    def _scan_impl(self, keys, spans) -> ClusterReadResult:
        keys = self._words(keys)
        spans = np.maximum(np.asarray(spans, np.int64).reshape(-1), 1)
        B = keys.shape[0]
        values = np.zeros((B, 4), U32)
        found = np.zeros((B,), bool)
        lat = np.zeros((B,))
        round_us = 0.0
        for name, m in self._route_serving(keys):
            node = self._nodes[name]
            km = keys[torch.from_numpy(m).to(self.device)]
            res = self._padded_lookup(node, km)
            vs, fs = _host(res.values), res.found.cpu().numpy()
            if node.mem is not None:
                plan = node.store.scan_plan(node.table, km, spans[m])
                try:
                    comp = node.mem.post(plan)
                except DeliveryTimeout:
                    self.chaos["read_timeouts"] += 1
                    continue
                lat[m] = comp.op_us[: int(m.sum())]
                round_us = max(round_us, comp.batch_us)
            values[m] = np.where(fs[:, None], vs, values[m])
            found[m] |= fs
        return ClusterReadResult(values, found, lat, round_us)

    # -- background maintenance: incremental per-shard resize ---------------
    def maintenance_step(self, budget: Optional[int] = 1,
                         trigger_lf: float = 0.85, factor: int = 2,
                         step_slo_us: Optional[float] = None) -> List[dict]:
        """One maintenance round, called between foreground batches: any
        serving shard past ``trigger_lf`` begins an incremental resize;
        shards mid-split advance ``budget`` cohorts and cut over when
        drained.  Foreground traffic keeps flowing the whole time — the
        split's per-pair tokens route it (`_padded_write`/`_padded_lookup`)
        — so growth never stops the world.  Schemes without mid-split
        routing (the baselines' one-shot ``resize_step``) are driven to
        cutover inside the round: the stop-the-world stall.
        ``step_slo_us`` hands sizing to the per-step stall SLO controller
        instead of a fixed cohort count: ``begin_resize`` derives the
        budget from the `LinkModel` and ``budget=None`` lets each step
        consume it.  Returns one action dict per shard touched.

        Every advancing step is priced (cohorts moved x the `LinkModel`
        cohort-move stall) against the step SLO — `DEFAULT_STEP_SLO_US`
        unless ``step_slo_us`` overrides it — feeding the
        ``maintenance.step_us`` gauge and, on overrun, the
        ``maintenance.slo_burn`` counter; a BLOCKING baseline resize is
        priced over its whole item count (the stop-the-world stall)."""
        with obs.span("cluster.maintenance"):
            return self._maintenance_impl(budget, trigger_lf, factor,
                                          step_slo_us)

    def _price_step(self, node: _Node, moved: int,
                    step_slo_us: Optional[float]) -> None:
        row = float(getattr(node.store.cfg, "row_bytes", 256))
        per = (self._link or LinkModel()).cohort_move_us(
            read_bytes=row, write_bytes=row + 16)
        step_us = moved * per
        slo = step_slo_us if step_slo_us is not None else DEFAULT_STEP_SLO_US
        reg = obs.get_registry()
        reg.gauge("maintenance.step_us", node=node.name).set(step_us)
        reg.gauge("maintenance.step_slo_us").set(slo)
        if step_us > slo:
            reg.counter("maintenance.slo_burn").inc()
            self.maintenance["slo_burns"] += 1
        obs.event("resize.step_priced", node=node.name, moved=moved,
                  step_us=round(step_us, 3), slo_us=slo)

    def _maintenance_impl(self, budget, trigger_lf, factor,
                          step_slo_us) -> List[dict]:
        actions: List[dict] = []
        for node in self._nodes.values():
            if not self._serving(node):
                continue
            if node.resize is None:
                lf = float(node.store.load_factor(node.table))
                if lf <= trigger_lf:
                    continue
                rs = node.store.begin_resize(node.table, factor,
                                             step_slo_us=step_slo_us)
                self.maintenance["resizes_begun"] += 1
                if not hasattr(node.store, "resize_write"):
                    node.store, node.table = node.store.resize_cutover(rs)
                    self.maintenance["blocking_resizes"] += 1
                    self._price_step(node, rs.n_items, step_slo_us)
                    obs.event("resize.blocking", node=node.name,
                              moved=rs.n_items)
                    actions.append({"node": node.name, "action": "blocking",
                                    "lf": lf, "moved": rs.n_items})
                    continue
                node.resize = rs
                node.table = rs.table
                obs.event("resize.begin", node=node.name,
                          cohorts=rs.store.cfg.num_pairs)
                actions.append({"node": node.name, "action": "begin",
                                "lf": lf, "cohorts": rs.store.cfg.num_pairs})
            else:
                moved = (budget if budget is not None
                         else (node.resize.step_budget or 1))
                rs = node.store.resize_step(node.resize, budget)
                node.table = rs.table
                self.maintenance["steps"] += 1
                self.maintenance["cohorts_moved"] += moved
                self._price_step(node, moved, step_slo_us)
                if rs.done:
                    node.store, node.table = node.store.resize_cutover(rs)
                    node.resize = None
                    self.maintenance["cutovers"] += 1
                    obs.event("resize.cutover", node=node.name,
                              moved=rs.moved)
                    actions.append({"node": node.name, "action": "cutover",
                                    "moved": rs.moved,
                                    "n_items": rs.n_items})
                else:
                    node.resize = rs
                    actions.append({"node": node.name, "action": "step",
                                    "moved": rs.moved})
        return actions

    # -- rebalance: live join / leave ---------------------------------------
    def begin_join(self, name: str,
                   node_slots: Optional[int] = None) -> _Migration:
        """COPY phase: add the node, ship it every key it will own.  Reads
        keep routing through the OLD directory (dual-read covers the
        window); `complete_join` is the cutover."""
        with obs.span("cluster.join.copy", node=name):
            return self._begin_join_impl(name, node_slots)

    def _begin_join_impl(self, name: str,
                         node_slots: Optional[int] = None) -> _Migration:
        assert self._mig is None, "a migration is already in flight"
        new_dir = self.directory.with_node(name)
        self._nodes[name] = self._make_node(name, node_slots)
        K, V = self._distinct_resident()
        if len(K):
            new_sets = self._sets(new_dir, K)
            to_new = (new_sets == self._id(name)).any(dim=1)
            moved_primary = int((new_sets[:, 0] == self._id(name)).sum())
            copied = int(to_new.sum())
            if copied:
                okn, _ = self._padded_write("insert", self._nodes[name],
                                            K[to_new], V[to_new])
                assert bool(okn.all()), "join target too small for its shard"
        else:
            moved_primary = copied = 0
        self._mig = _Migration(new_dir, len(K), copied, moved_primary)
        return self._mig

    def complete_join(self) -> RebalanceReport:
        """CUTOVER (one host-atomic directory swap — the PM token twin is
        `migration.token_record`) + CLEANUP (drop un-owned copies)."""
        assert self._mig is not None, "no migration in flight"
        mig = self._mig
        joined = set(mig.new_dir.nodes) - set(self.directory.nodes)
        obs.event("cluster.join.cutover", node=next(iter(joined)),
                  copied=mig.copied)
        self.directory = mig.new_dir
        self._mig = None
        self._bump_epoch()
        cleaned = self._cleanup()
        return RebalanceReport(
            kind="join", node=next(iter(joined)), resident=mig.resident,
            moved_primary=mig.moved_primary, copied=mig.copied,
            cleaned=cleaned, bound=1.0 / len(self.directory.nodes) + 0.05)

    def join(self, name: str,
             node_slots: Optional[int] = None) -> RebalanceReport:
        self.begin_join(name, node_slots)
        return self.complete_join()

    def leave(self, name: str) -> RebalanceReport:
        """Graceful decommission: re-home the leaving node's keys, cut
        over, drop the node."""
        assert self._mig is None, "complete the in-flight migration first"
        assert self.is_alive(name), name
        new_dir = self.directory.without_node(name)
        K, V = self._distinct_resident()
        copied = 0
        if len(K):
            old_sets = self._sets(self.directory, K)
            new_sets = self._sets(new_dir, K)
            moved_primary = int((old_sets[:, 0] != new_sets[:, 0]).sum())
            for node in self._nodes.values():
                if node.name == name or not node.alive:
                    continue
                i = self._id(node.name)
                gains = ((new_sets == i).any(dim=1)
                         & ~(old_sets == i).any(dim=1))
                if bool(gains.any()):
                    okn, _ = self._padded_write("insert", node, K[gains],
                                                V[gains])
                    copied += int(okn.sum())
        else:
            moved_primary = 0
        self.directory = new_dir
        del self._nodes[name]
        self._bump_epoch()
        return RebalanceReport(
            kind="leave", node=name, resident=len(K),
            moved_primary=moved_primary, copied=copied, cleaned=0,
            bound=1.0 / (len(new_dir.nodes) + 1) + 0.05)

    def _cleanup(self) -> int:
        cleaned = 0
        for node in self._nodes.values():
            if not self._serving(node):
                continue
            K, _ = self._resident(node)
            if not len(K):
                continue
            drop = ~self._owned(self.directory, K, node.name)
            if bool(drop.any()):
                okn, _ = self._padded_write("delete", node, K[drop], None)
                cleaned += int(okn.sum())
        return cleaned

    # -- failure ------------------------------------------------------------
    def kill(self, name: str) -> None:
        """Crash a node: it goes silent, its PM image frozen as-is.
        Detection (heartbeat timeout) and promotion are the
        `FailoverController`'s job."""
        self._nodes[name].alive = False
        obs.event("cluster.kill", node=name)

    # -- partitions & fencing ----------------------------------------------
    def partition(self, name: str) -> None:
        """Cut a node off the cluster network: it stays ALIVE (its image
        keeps accepting whatever `stale_write` injects) but the
        coordinator cannot reach it.  The epoch bump is the fence —
        every reachable node gets the new token, the partitioned node
        keeps the old one, and `_serving` refuses it from then on."""
        node = self._nodes[name]
        assert node.alive and node.reachable, name
        node.reachable = False
        obs.event("cluster.partition", node=name)
        self._bump_epoch()

    def heal(self, name: str) -> None:
        """The partition heals: the node is reachable again but still
        holds its OLD epoch token, so routing keeps it fenced (the
        replica-lag window) until `resync` reconciles its image."""
        node = self._nodes[name]
        assert node.alive and not node.reachable, name
        node.reachable = True
        obs.event("cluster.heal", node=name)

    def stale_write(self, name: str, keys, vals) -> int:
        """A client that has not heard about the partition writes THROUGH
        the stale ex-primary, which acks alone — the unfenced-ack hazard
        `replication.check_replicated_durability`'s negative control
        demonstrates.  Every such ack is logged with the node's (stale)
        epoch; `resync` or `failover` must detect ALL of them
        (``chaos['stale_acks_detected'] == chaos['stale_acks_injected']``)
        and none may survive into the keyspace."""
        node = self._nodes[name]
        assert node.alive and not node.reachable, name
        keys, vals = self._words(keys), self._words(vals)
        fnd = self._padded_lookup(node, keys).found
        if bool(fnd.any()):
            self._padded_write("update", node, keys[fnd], vals[fnd])
        if bool((~fnd).any()):
            self._padded_write("insert", node, keys[~fnd], vals[~fnd])
        node.stale_log.append((keys, vals, node.epoch))
        self.chaos["stale_acks_injected"] += int(keys.shape[0])
        return int(keys.shape[0])

    def _detect_stale(self, node: _Node) -> int:
        """Fence check: every logged ack carrying an epoch older than the
        directory's is detected (and its divergence discarded with the
        image).  Returns the count and clears the log."""
        detected = sum(len(k) for k, _, e in node.stale_log
                       if e < self.epoch)
        node.stale_log.clear()
        self.chaos["stale_acks_detected"] += detected
        return detected

    def resync(self, name: str) -> HealReport:
        """Re-admit a healed node by RECONCILING its image against the
        serving replicas — never by wiping it, because the node may hold
        the sole surviving copy of committed keys whose co-replica died
        while it was partitioned.  Three passes:

          1. stale-ack repair: every key the node acked while fenced is
             overwritten from the current primaries where they hold it
             and DELETED where they do not (a stale insert must not
             resurface as a legitimate sole copy);
          2. catch-up: every authoritative key the node owns is inserted
             if missing and overwritten if divergent (writes it missed
             while out of the set);
          3. garbage: copies of keys it no longer owns are dropped (they
             stop receiving updates and would silently go stale).

        Then the node gets the current epoch token and `_serving`
        accepts it again."""
        with obs.span("cluster.resync", node=name):
            return self._resync_impl(name)

    def _resync_impl(self, name: str) -> HealReport:
        node = self._nodes[name]
        assert node.alive and node.reachable, name
        assert node.epoch < self.epoch, f"{name} is already current"
        stale = [k for k, _, e in node.stale_log if e < self.epoch]
        stale_keys = (torch.cat(stale) if stale else
                      torch.zeros((0, 4), dtype=torch.int32,
                                  device=self.device))
        detected = self._detect_stale(node)
        K, V = self._distinct_resident()    # authoritative (excludes node)
        if len(stale_keys):
            held = _rows_in(stale_keys, K)
            if bool((~held).any()):
                self._padded_write("delete", node, stale_keys[~held], None)
            # held ones are refreshed by the catch-up pass below
        resynced = 0
        if len(K):
            own = self._owned(self.directory, K, name)
            if bool(own.any()):
                Ko, Vo = K[own], V[own]
                res = self._padded_lookup(node, Ko)
                have = res.found
                div = have & (res.values != Vo).any(dim=1)
                if bool((~have).any()):
                    okn, _ = self._padded_write("insert", node, Ko[~have],
                                                Vo[~have])
                    resynced += int(okn.sum())
                if bool(div.any()):
                    resynced += self._overwrite(node, Ko[div], Vo[div])[0]
        Kn, Vn = self._resident(node)
        if len(Kn):
            unowned = ~self._owned(self.directory, Kn, name)
            # an un-owned key with NO authoritative holder is a sole
            # surviving copy (its owners died while this node was out):
            # re-home it to its serving owners before dropping it here
            orphan = unowned & ~_rows_in(Kn, K)
            if bool(orphan.any()):
                osets = self._sets(self.directory, Kn[orphan])
                for other in self._nodes.values():
                    if other is node or not self._serving(other):
                        continue
                    g = (osets == self._id(other.name)).any(dim=1)
                    if bool(g.any()):
                        self._padded_write("insert", other,
                                           Kn[orphan][g], Vn[orphan][g])
            if bool(unowned.any()):
                self._padded_write("delete", node, Kn[unowned], None)
        node.epoch = self.epoch
        obs.event("cluster.resynced", node=name, stale_detected=detected,
                  resynced=resynced)
        return HealReport(node=name, stale_acks_detected=detected,
                          resynced=resynced)

    def quiesce_faults(self) -> None:
        """Disable delivery-fault injection on every endpoint (and for
        nodes made later).  The audit phase calls this: it measures
        durability, not delivery luck — a dropped audit READ must not
        masquerade as lost data."""
        self._faults = None
        for node in self._nodes.values():
            if node.mem is not None:
                node.mem.faults = None

    def failover(self, dead: str) -> FailoverReport:
        """Promote the failed node's replicas: directory removal re-ranks
        them to primary, every survivor runs its scheme's restart
        procedure on its (possibly mid-write) image, and the lost
        replica count is restored from the new primaries.  ``dead`` may
        be crashed OR partitioned past the suspicion grace window — a
        partitioned ex-primary is fenced out the same way, and every
        stale ack it took is detected here."""
        with obs.span("cluster.failover", node=dead):
            return self._failover_impl(dead)

    def _failover_impl(self, dead: str) -> FailoverReport:
        node = self._nodes[dead]
        assert not (node.alive and node.reachable), dead
        self._detect_stale(node)
        old_dir = self.directory
        if dead not in old_dir.nodes:
            # a joiner died inside its own migration window: it owned
            # nothing yet (the source is still authoritative), so the
            # join is void — drop the node and its copies, promote nobody
            assert self._mig is not None and dead in self._mig.new_dir.nodes
            self._mig = None
            del self._nodes[dead]
            return FailoverReport(dead=dead, promoted_keys=0, recopied=0,
                                  recovery={})
        new_dir = old_dir.without_node(dead)
        if self._mig is not None:
            # a primary died inside a migration window: the PENDING
            # cutover must target the post-failover membership, or
            # complete_join would resurrect the dead node (and is moot
            # when the dead node IS the joiner)
            nd = (self._mig.new_dir.without_node(dead)
                  if dead in self._mig.new_dir.nodes else self._mig.new_dir)
            if set(nd.nodes) == set(new_dir.nodes):
                self._mig = None
            else:
                self._mig = dataclasses.replace(self._mig, new_dir=nd)
        recovery = {}
        obs.event("failover.fenced", node=dead, epoch=self.epoch)
        for node in self._nodes.values():
            if not self._serving(node):
                continue
            node.table, report = node.store.recover(node.table)
            obs.event("failover.recovered", node=node.name)
            if node.resize is not None:
                # a survivor mid-split restarts BOTH images; the handle
                # resumes from the recovered tables (tokens are host
                # state here — PM-token recovery is the matrix cell's job)
                rs = node.resize
                new_table, _ = rs.new_store.recover(rs.new_table)
                node.resize = dataclasses.replace(
                    rs, table=node.table, new_table=new_table)
            recovery[node.name] = report
        del self._nodes[dead]
        self.directory = new_dir
        self._bump_epoch()
        K, V = self._distinct_resident()
        promoted = recopied = 0
        if len(K):
            promoted = int((self._sets(old_dir, K)[:, 0]
                            == self._id(dead)).sum())
            new_sets = self._sets(new_dir, K)
            for node in self._nodes.values():
                if not self._serving(node):
                    continue
                need = (new_sets == self._id(node.name)).any(dim=1)
                if not bool(need.any()):
                    continue
                idx = need.nonzero().squeeze(1)
                res = self._padded_lookup(node, K[idx])
                have = res.found
                # backfill missing copies AND refresh stale ones: a node
                # re-entering a key's replica set after churn may hold a
                # leftover copy that stopped receiving updates while it
                # was out of the set — re-ranked to primary, that stale
                # copy would serve unless re-replication overwrites it
                stale = have & (res.values != V[idx]).any(dim=1)
                miss, fix = idx[~have], idx[stale]
                if len(miss):
                    okn, _ = self._padded_write("insert", node, K[miss],
                                                V[miss])
                    recopied += int(okn.sum())
                if len(fix):
                    recopied += self._overwrite(node, K[fix], V[fix])[0]
        obs.event("failover.promoted", node=dead, promoted=promoted,
                  recopied=recopied)
        return FailoverReport(dead=dead, promoted_keys=promoted,
                              recopied=recopied, recovery=recovery)

    # -- diagnostics --------------------------------------------------------
    def total_resident(self) -> int:
        return len(self._distinct_resident()[0])

    def metrics_view(self) -> obs.MetricsRegistry:
        """ONE registry merged across every node endpoint (counters add,
        histograms merge buckets, gauges keep the worst observed) — the
        cross-node roll-up a traced run exports.  Per-node registries
        stay intact on each `RemoteMemory`."""
        reg = obs.MetricsRegistry()
        for node in self._nodes.values():
            if node.mem is not None:
                reg.merge(node.mem.metrics)
        return reg

    def stats(self) -> dict:
        out = {"scheme": self.scheme, "nodes": {}, "replicas":
               self.directory.replicas, "migrating": self._mig is not None,
               "epoch": self.epoch, "read_only": self.read_only,
               "chaos": dict(self.chaos),
               "maintenance": dict(self.maintenance)}
        for node in self._nodes.values():
            st = {"alive": node.alive, "reachable": node.reachable,
                  "epoch": node.epoch, "resizing": node.resize is not None,
                  "resident": int(len(self._resident(node)[0]))}
            if node.mem is not None:
                st["wire"] = node.mem.stats()
            out["nodes"][node.name] = st
        return out
