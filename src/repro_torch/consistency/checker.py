"""Crash-matrix checker: inject every crash point, recover, verify.

Port of ``repro.consistency.checker``.

The verified property is the paper's §III-C claim, stated operationally:

  for EVERY prefix of a batch op's PM store trace (and every torn split
  of each non-atomic store), recovery yields a table in which each batch
  op is atomically visible or invisible — insert: the key maps to its
  exact value or is absent; update: the value is exactly-old or
  exactly-new; delete: present-with-old-value or absent — and no
  untouched key changed.

For serial traces the checker additionally asserts the stronger
batch-prefix property: since commits land in batch order, the recovered
item set must equal the base set plus a PREFIX of the batch's committed
ops.  (Wave traces only guarantee per-pair prefix order, so they get the
all-or-nothing check plus durable-final-state equivalence.)

A `CaseResult` aggregates the sweep for one (scheme, op) cell — crash
point counts, violations (expected to be non-empty ONLY for the dense
in-place-update negative control), and the merged `RecoveryReport` that
feeds the recovery-work-per-scheme table.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.consistency.recovery import RecoveryReport
from repro_torch.consistency.schemes import HANDLERS, trace_batch
from repro_torch.consistency.trace import PMTrace, crash_states

Items = Dict[bytes, bytes]


def serial_prefix_items(base: Items, trace: PMTrace) -> List[Items]:
    """Item sets after each committed-op prefix, in batch order."""
    out = [dict(base)]
    cur = dict(base)
    for o in trace.ops:
        if not o.ok:
            continue
        if o.op == "delete":
            cur.pop(o.key, None)
        else:
            cur[o.key] = o.val
        out.append(dict(cur))
    return out


def all_or_nothing_violations(base: Items, trace: PMTrace,
                              vis: Items) -> List[str]:
    """Per-op atomic-visibility violations of a recovered item set.

    Assumes each key appears in at most one batch op (the matrix builds
    its batches that way); a multi-op-per-key batch would need the
    per-key op-order closure instead.
    """
    out = []
    op_keys = set()
    for o in trace.ops:
        op_keys.add(o.key)
        if not o.ok:
            continue
        old = base.get(o.key)
        if o.op == "insert":
            allowed = {None, o.val}
        elif o.op == "update":
            allowed = {old, o.val}
        else:
            allowed = {old, None}
        got = vis.get(o.key)
        if got not in allowed:
            out.append(f"op {o.op_id} ({o.op}) torn/partial: key neither "
                       f"old nor new")
    for k, v in base.items():
        if k not in op_keys and vis.get(k) != v:
            out.append("untouched key changed or lost")
    for k in vis:
        if k not in base and k not in op_keys:
            out.append("phantom key appeared")
    return out


@dataclasses.dataclass
class CaseResult:
    scheme: str
    op: str
    order: str
    paths: List[str]                  # per-op write path taken
    crash_points: int
    torn_points: int
    violations: List[str]
    log_records_in_trace: int
    log_used_points: int              # crash points whose recovery read the log
    report: RecoveryReport            # merged over all crash points
    final_items: Items

    @property
    def consistent(self) -> bool:
        return not self.violations

    @property
    def log_free(self) -> bool:
        return self.log_records_in_trace == 0 and self.log_used_points == 0


def run_case(store, table, op: str, keys, vals=None, mask=None,
             order: str = "serial", include_torn: bool = True) -> CaseResult:
    """Sweep every crash point of one traced batch op through recovery
    (routing on the store's device; ``table`` is read, never changed)."""
    handler = HANDLERS[store.name]
    cfg = store.cfg
    base_state = handler.init_state(cfg, table)
    base_items = handler.visible(cfg, base_state)
    final_state, trace = trace_batch(handler, cfg, base_state, op, keys,
                                     vals, mask, order, device=store.device)
    prefixes = (serial_prefix_items(base_items, trace)
                if order == "serial" else None)
    violations: List[str] = []
    merged: Optional[RecoveryReport] = None
    n_crash = n_torn = log_pts = 0
    for cs in crash_states(base_state, trace, include_torn=include_torn):
        n_crash += 1
        n_torn += int(cs.torn)
        rec_state, report = handler.recover(cfg, cs.state)
        merged = report if merged is None else merged.merge(report)
        log_pts += int(report.log_records_used > 0)
        vis = handler.visible(cfg, rec_state)
        for v in all_or_nothing_violations(base_items, trace, vis):
            violations.append(f"{cs.label}: {v}")
        if prefixes is not None and vis not in prefixes:
            violations.append(f"{cs.label}: recovered set is not a "
                              f"batch-order prefix")
    # the full trace must land on the last committed prefix
    full_rec, _ = handler.recover(cfg, final_state)
    final_items = handler.visible(cfg, full_rec)
    if prefixes is not None and final_items != prefixes[-1]:
        violations.append("full trace: final state != all-committed prefix")
    return CaseResult(
        scheme=store.name, op=op, order=order,
        paths=[o.path for o in trace.ops],
        crash_points=n_crash, torn_points=n_torn, violations=violations,
        log_records_in_trace=trace.log_records(), log_used_points=log_pts,
        report=merged if merged is not None else RecoveryReport(store.name),
        final_items=final_items)
