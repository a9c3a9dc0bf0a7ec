"""Crash-consistent live shard migration: COPY -> TOKEN CUTOVER -> CLEANUP.

Port of ``repro.cluster.migration`` (host-side numpy over the port's
`repro_torch.consistency` handlers).  Rebalance (node join/leave) moves
resident keys between PM nodes while both keep serving.  The protocol is
the paper's one-word-commit discipline lifted one level up:

  COPYING   the destination receives the moving items as ordinary traced
            inserts (each individually crash-atomic under its scheme's
            own discipline).  Reads run DUAL: the source stays
            authoritative; a destination copy is only ever a byte-equal
            duplicate, so reading the union is always correct.
  CUTOVER   ONE atomic 8-byte migration-token store flips ownership.
            Before the token persists the migration never happened
            (destination copies are harmless duplicates, re-copy is
            idempotent); after it the destination owns the keys.
  CLEANUP   the source deletes the moved items (each delete crash-atomic;
            leftovers are byte-equal duplicates under dual-read until
            the window closes).

`migration_crash_sweep` proves the invariant the matrix CLI gates: at
EVERY crash prefix of the composite trace (dest inserts + token + source
deletes, including torn splits of non-atomic stores), recovering both
tables and resolving reads by token yields EXACTLY the original item
set — zero loss, zero corruption, no phantom — with no migration log.

The composite PM image prefixes the two tables' leaves (``src/``,
``dst/``) plus the token word, so the existing injector
(`consistency.trace.crash_states`) sweeps it unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.consistency.recovery import RecoveryReport
from repro_torch.consistency.schemes import HANDLERS, trace_batch
from repro_torch.consistency.trace import (PMStore, PMTrace, State, SubWrite,
                                     crash_states)

MIG_TOKEN = "__mig_token__"      # composite-state key of the cutover word
TOKEN_ADDR = 1 << 31             # symbolic PM address of the token


def _prefix_records(records, tag: str):
    return [dataclasses.replace(
        r, writes=tuple(SubWrite(tag + w.field, w.index, w.value)
                        for w in r.writes))
        for r in records]


def _split(state: State, tag: str) -> State:
    n = len(tag)
    return {f[n:]: v for f, v in state.items() if f.startswith(tag)}


def token_record(op_id: int, committed: bool = True) -> PMStore:
    """The cutover commit: one atomic 8-byte store (not Table-I-counted —
    it is per MIGRATION, not per op)."""
    return PMStore(op_id, "token", True, TOKEN_ADDR, 8, False,
                   (SubWrite(MIG_TOKEN, (), np.uint64(1 if committed else 0)),))


def build_migration_trace(store, src_table, dst_table, keys, vals
                          ) -> Tuple[State, PMTrace]:
    """Compose the full migration PM trace over the prefixed joint image.

    ``keys``/``vals`` are the moving items (resident on src).  Records:
    dst-side traced inserts, the token store, src-side traced deletes —
    exactly the order the live path issues them.
    """
    handler = HANDLERS[store.name]
    cfg = store.cfg
    src_state = handler.init_state(cfg, src_table)
    dst_state = handler.init_state(cfg, dst_table)

    # a migration COPIES: every moving item must be src-resident with
    # exactly this value, else dual-read resolution would be wrong
    src_items = handler.visible(cfg, src_state)
    kn = np.asarray(keys, np.uint32).reshape(-1, 4)
    vn = np.asarray(vals, np.uint32).reshape(-1, 4)
    for k, v in zip(kn, vn):
        assert src_items.get(k.tobytes()) == v.tobytes(), \
            "migrating item is not src-resident with this exact value"

    _, ins_trace = trace_batch(handler, cfg, dst_state, "insert",
                               keys, vals, device=store.device)
    assert all(o.ok for o in ins_trace.ops), \
        "destination too full to receive the moving items"
    _, del_trace = trace_batch(handler, cfg, src_state, "delete", keys,
                               device=store.device)

    base: State = {MIG_TOKEN: np.zeros((), np.uint64)}
    for f, v in src_state.items():
        base["src/" + f] = v
    for f, v in dst_state.items():
        base["dst/" + f] = v
    records = (_prefix_records(ins_trace.records, "dst/")
               + [token_record(len(ins_trace.ops))]
               + _prefix_records(del_trace.records, "src/"))
    ops = list(ins_trace.ops) + list(del_trace.ops)
    return base, PMTrace(store.name, "migrate", records, ops)


@dataclasses.dataclass
class MigrationSweep:
    """Exhaustive crash sweep of one shard migration."""

    scheme: str
    moved: int
    crash_points: int
    torn_points: int
    token_cut_index: int            # record index of the cutover store
    violations: List[str]
    log_records_in_trace: int
    report: RecoveryReport          # merged recovery work over all points

    @property
    def consistent(self) -> bool:
        return not self.violations

    @property
    def log_free(self) -> bool:
        return self.log_records_in_trace == 0 \
            and self.report.log_records_used == 0


def resolve_dual_read(handler, cfg, state: State) -> Dict[bytes, bytes]:
    """What a dual-reading client durably sees in a (recovered) composite
    image: the union of both tables, source-authoritative before the
    token, destination-authoritative after.  Copies are byte-equal, so
    precedence only matters for torn edges — which each side's own
    recovery already ruled out."""
    src = handler.visible(cfg, _split(state, "src/"))
    dst = handler.visible(cfg, _split(state, "dst/"))
    if int(state[MIG_TOKEN]) == 0:
        return {**dst, **src}       # src wins key collisions
    return {**src, **dst}           # dst wins


def migration_crash_sweep(store, src_table, dst_table, keys, vals,
                          include_torn: bool = True) -> MigrationSweep:
    """Inject a crash at every PM-store boundary of the migration (and
    every torn split), recover BOTH tables, resolve by token, and require
    the resolved set to equal the pre-migration item set at every point.
    """
    handler = HANDLERS[store.name]
    cfg = store.cfg
    base, trace = build_migration_trace(store, src_table, dst_table,
                                        keys, vals)
    want = resolve_dual_read(handler, cfg, base)
    token_idx = next(i for i, r in enumerate(trace.records)
                     if r.writes[0].field == MIG_TOKEN)

    violations: List[str] = []
    merged = RecoveryReport(store.name)
    n_crash = n_torn = 0
    for cs in crash_states(base, trace, include_torn=include_torn):
        n_crash += 1
        n_torn += int(cs.torn)
        src_rec, r1 = handler.recover(cfg, _split(cs.state, "src/"))
        dst_rec, r2 = handler.recover(cfg, _split(cs.state, "dst/"))
        merged = merged.merge(r1).merge(r2)
        joined: State = {MIG_TOKEN: cs.state[MIG_TOKEN]}
        for f, v in src_rec.items():
            joined["src/" + f] = v
        for f, v in dst_rec.items():
            joined["dst/" + f] = v
        got = resolve_dual_read(handler, cfg, joined)
        if got != want:
            lost = sum(1 for k in want if got.get(k) != want[k])
            phantom = sum(1 for k in got if k not in want)
            violations.append(f"{cs.label}: resolved set diverged "
                              f"({lost} lost/torn, {phantom} phantom)")
    return MigrationSweep(
        scheme=store.name, moved=len(trace.ops) // 2,
        crash_points=n_crash, torn_points=n_torn,
        token_cut_index=token_idx, violations=violations,
        log_records_in_trace=trace.log_records(), report=merged)
