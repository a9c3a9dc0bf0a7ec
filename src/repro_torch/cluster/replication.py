"""Primary -> replica replicated writes with the remote-persist fence
discipline, and the checker that PROVES the discipline loses nothing.

Port of ``repro.cluster.replication`` (host-side numpy over the port's
`repro_torch.consistency` handlers; routing runs on the store's device).
The primary executes a write batch and ships the op's ordered PM store
sequence — exactly the `PMTrace` the consistency subsystem records — to
each replica as one-sided RDMA WRITEs.  A store is *visible* at the
replica once the NIC ACKs it, *persisted* only after a remote-persist
fence drains it to the PM media.  The protocol ACKs an op to the client
only when the fence covering the op's LAST store has completed at the
replica; under the schemes' commit-fence discipline
(`fence_after_commits`) that last store IS a commit-kind store for every
committed path, so

    acked  ==>  the op's commit word is on the replica's PM media,

and a primary crash at ANY point can lose no committed op: promotion
recovers the replica's PERSISTED image and every acked commit is in it.
`check_replicated_durability` proves this exhaustively — every remote
cut of the replica delivery, recovery on the persisted image, per-op
atomic-visibility check — and keeps the UNFENCED delivery (ACK on NIC
visibility) as the detected negative control: there it finds
acked-but-lost ops, the bug class the fence discipline rules out.

Wire pricing reuses the verb layer: `replication_plan` turns a trace
into the (B_ops, M) fenced WRITE `VerbPlan` a replica endpoint posts, so
replica traffic shows up in the same doorbell/latency model as reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.consistency.checker import all_or_nothing_violations
from repro_torch.consistency.recovery import RecoveryReport
from repro_torch.consistency.schemes import HANDLERS, trace_batch
from repro_torch.consistency.trace import (PMTrace, fence_after_commits,
                                     remote_crash_states)
from repro_torch.rdma import verbs as rv


def op_ack_indices(trace: PMTrace) -> Dict[int, int]:
    """{op_id: index of the op's LAST store record} for successful ops —
    the record whose fence completion triggers the client ACK."""
    last: Dict[int, int] = {}
    for i, rec in enumerate(trace.records):
        last[rec.op_id] = i
    return {o.op_id: last[o.op_id] for o in trace.ops
            if o.ok and o.op_id in last}


def replication_plan(trace: PMTrace,
                     fences: Optional[Tuple[int, ...]] = None) -> rv.VerbPlan:
    """The fenced one-sided WRITE plan a replica delivery posts.

    One WRITE verb per PM store record, one row per op.  Stores between
    fences share a dependency depth (they may write-combine into one
    round); each fenced store closes its round, so the next store is a
    new dependent round trip — the ordering rule that makes remote
    persistence correct.
    """
    fset = set(fence_after_commits(trace) if fences is None else fences)
    # per op: (region, addr, nbytes, fenced, depth) — depth is the count
    # of this op's fences BEFORE the store (each fence closes a round)
    rows: Dict[int, List[Tuple[int, int, int, bool, int]]] = {}
    fences_seen: Dict[int, int] = {}
    for i, rec in enumerate(trace.records):
        d = fences_seen.get(rec.op_id, 0)
        region = rv.REGION_LOG if rec.kind.startswith("log") else rv.REGION_TABLE
        rows.setdefault(rec.op_id, []).append(
            (region, rec.addr, rec.nbytes, i in fset, d))
        if i in fset:
            fences_seen[rec.op_id] = d + 1
    if not rows:
        return rv.pack(1, [(rv.NOOP, rv.REGION_TABLE, 0, 0, 0, False)])
    order = sorted(rows)
    lanes = []
    for m in range(max(len(v) for v in rows.values())):
        cols = [rows[o][m] if m < len(rows[o]) else (0, 0, 0, False, 0)
                for o in order]
        active = [m < len(rows[o]) for o in order]
        lanes.append((np.where(active, rv.WRITE, rv.NOOP),
                      np.array([c[0] for c in cols]),
                      np.array([c[1] for c in cols]) & 0x7FFFFFFF,
                      np.array([c[2] for c in cols]),
                      np.array([c[4] for c in cols]),
                      np.array([c[3] for c in cols])))
    return rv.pack(len(order), lanes)


@dataclasses.dataclass
class ReplicaCheck:
    """Exhaustive primary-crash sweep result for one replicated batch.

    ``cuts``            remote crash points swept (one per store boundary);
    ``acked_total``     op-acks outstanding summed over all cuts;
    ``lost_committed``  acked ops MISSING from the recovered persisted
                        image, summed over cuts (0 iff the discipline is
                        sound);
    ``violations``      per-op atomic-visibility failures on recovered
                        images (labels name the cut);
    ``fenced``          which delivery discipline was swept;
    ``report``          merged recovery work over every cut.
    """

    scheme: str
    op: str
    fenced: bool
    cuts: int
    acked_total: int
    lost_committed: int
    violations: List[str]
    report: RecoveryReport

    @property
    def zero_loss(self) -> bool:
        return self.lost_committed == 0 and not self.violations


def check_replicated_durability(store, table, op: str, keys, vals=None,
                                mask=None, fenced: bool = True,
                                order: str = "serial") -> ReplicaCheck:
    """Sweep EVERY primary-crash point of one replicated write batch.

    The replica starts from the same durable image as the primary (it
    mirrors the shard), receives the batch's PM store sequence as RDMA
    WRITEs, and the primary's power is cut after each store's NIC ACK.
    At every cut: recover the replica's PERSISTED image (never the
    visible one — that is the whole point), then require

      * every op acked at that cut is exactly-new in the recovered image
        (insert/update) or exactly-absent (delete);
      * every op, acked or not, is atomically visible or invisible
        (`all_or_nothing_violations`).

    ``fenced=True`` swept under `fence_after_commits` must return
    ``zero_loss``; ``fenced=False`` (ACK on NIC visibility, no fences) is
    the negative control and must NOT — callers assert both directions.
    """
    handler = HANDLERS[store.name]
    cfg = store.cfg
    base_state = handler.init_state(cfg, table)
    base_items = handler.visible(cfg, base_state)
    _, trace = trace_batch(handler, cfg, base_state, op, keys, vals, mask,
                           order=order, device=store.device)
    fences = fence_after_commits(trace) if fenced else ()
    ack_at = op_ack_indices(trace)
    by_id = {o.op_id: o for o in trace.ops}

    acked_total = lost = cuts = 0
    violations: List[str] = []
    merged: Optional[RecoveryReport] = None
    for cs in remote_crash_states(base_state, trace, fences=fences):
        cuts += 1
        horizon = cs.fenced_done if fenced else cs.records_done
        rec_state, report = handler.recover(cfg, cs.persisted)
        merged = report if merged is None else merged.merge(report)
        vis = handler.visible(cfg, rec_state)
        for op_id, last_idx in ack_at.items():
            if last_idx >= horizon:
                continue                    # not yet acked at this cut
            acked_total += 1
            o = by_id[op_id]
            if o.op == "delete":
                good = o.key not in vis
            else:
                good = vis.get(o.key) == o.val
            if not good:
                lost += 1
                violations.append(
                    f"{cs.label}: acked {o.op} op {op_id} lost or torn "
                    f"after recovery")
        for v in all_or_nothing_violations(base_items, trace, vis):
            violations.append(f"{cs.label}: {v}")
    return ReplicaCheck(
        scheme=store.name, op=op, fenced=fenced, cuts=cuts,
        acked_total=acked_total, lost_committed=lost,
        violations=violations,
        report=merged if merged is not None else RecoveryReport(store.name))
