"""Crash-consistent incremental resize: per-cohort COPY -> TOKEN -> CLEANUP.

Port of ``repro.consistency.split``; routing runs on the store's device.

The online split (`repro_torch.core.continuity.split_begin/split_step`)
grows a
table without stopping the world: each OLD pair (one bucket-group cohort)
is moved on its own, under the same one-word-commit discipline the live
migration uses, but with a per-pair token ARRAY instead of one shard-wide
word:

  COPYING   the cohort's items land in the grown table as ordinary traced
            inserts (each individually crash-atomic).  Reads run DUAL: the
            old pair stays authoritative while its token is 0 — a new-side
            copy is only ever a byte-equal duplicate.
  CUTOVER   ONE atomic 8-byte store of the cohort's token flips ownership
            of exactly that pair.  Other pairs are untouched: the split is
            incremental BECAUSE the commit granule is per-cohort.
  CLEANUP   the old pair's items are deleted (each delete crash-atomic;
            leftovers are byte-equal duplicates under dual-read until the
            cohort's window closes).

`split_crash_sweep` proves the matrix-gated invariant: at EVERY crash
prefix of the composite trace (all cohorts' copy/token/cleanup records in
step order, plus every torn split of non-atomic stores), recovering both
tables and resolving reads per-pair by token yields EXACTLY the original
item set — zero loss, zero phantom, zero resize log.

The composite PM image prefixes the two tables' leaves (``old/``,
``new/``) plus the token array, so the EXISTING injector
(`repro_torch.consistency.trace.crash_states`) sweeps it unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.consistency.recovery import RecoveryReport
from repro_torch.consistency.schemes import HANDLERS, trace_batch
from repro_torch.consistency.trace import (PMStore, PMTrace, State, SubWrite,
                                           crash_states)

SPLIT_TOKEN = "__split_token__"   # composite-state key of the token array
TOKEN_BASE = 1 << 30              # symbolic PM base of the token words


def _prefix_records(records, tag: str):
    return [dataclasses.replace(
        r, writes=tuple(SubWrite(tag + w.field, w.index, w.value)
                        for w in r.writes))
        for r in records]


def _split_state(state: State, tag: str) -> State:
    n = len(tag)
    return {f[n:]: v for f, v in state.items() if f.startswith(tag)}


def token_record(op_id: int, pair: int) -> PMStore:
    """The cohort cutover commit: one atomic 8-byte store of pair
    ``pair``'s token word (not Table-I-counted — per COHORT, not per op)."""
    return PMStore(op_id, "token", True, TOKEN_BASE + 8 * pair, 8, False,
                   (SubWrite(SPLIT_TOKEN, (pair,), np.uint64(1)),))


def build_split_trace(store, table, factor: int = 2
                      ) -> Tuple[State, PMTrace]:
    """Compose the full incremental-resize PM trace over the prefixed
    joint image: for each old pair in step order, the cohort's new-side
    traced inserts, its token store, then its old-side traced deletes —
    exactly the order `split_step` issues them."""
    handler = HANDLERS[store.name]
    cfg = store.cfg
    dev = store.device
    new_cfg = cfg.grow(factor)
    old_state = handler.init_state(cfg, table)
    new_state = handler.init_state(new_cfg, store._mod.create(new_cfg, dev))

    items = handler.visible(cfg, old_state)
    kn = (np.frombuffer(b"".join(items.keys()), np.uint32).reshape(-1, 4)
          if items else np.zeros((0, 4), np.uint32))
    vn = (np.frombuffer(b"".join(items.values()), np.uint32).reshape(-1, 4)
          if items else np.zeros((0, 4), np.uint32))
    pairs = np.asarray(handler.route(cfg, kn, dev)[0]) if len(kn) else \
        np.zeros((0,), np.int32)

    base: State = {SPLIT_TOKEN: np.zeros((cfg.num_pairs,), np.uint64)}
    for f, v in old_state.items():
        base["old/" + f] = v.copy()
    for f, v in new_state.items():
        base["new/" + f] = v.copy()

    records: List[PMStore] = []
    ops = []
    for p in range(cfg.num_pairs):
        sel = pairs == p
        kc, vc = kn[sel], vn[sel]
        if len(kc):
            new_state, ins_tr = trace_batch(handler, new_cfg, new_state,
                                            "insert", kc, vc, device=dev)
            if not all(o.ok for o in ins_tr.ops):
                raise RuntimeError(
                    f"grown table too full to receive cohort {p}")
            records += _prefix_records(ins_tr.records, "new/")
            ops += ins_tr.ops
        records.append(token_record(len(ops), p))
        if len(kc):
            old_state, del_tr = trace_batch(handler, cfg, old_state,
                                            "delete", kc, device=dev)
            records += _prefix_records(del_tr.records, "old/")
            ops += del_tr.ops
    return base, PMTrace(store.name, "resize", records, list(ops))


def resolve_dual_read(handler, cfg, new_cfg, state: State, device
                      ) -> Dict[bytes, bytes]:
    """What a dual-reading client durably sees in a (recovered) composite
    image: per key, the OLD pair is authoritative while its token is 0,
    the grown table after.  Copies are byte-equal in the in-flight window,
    so precedence only matters for torn edges — which each side's own
    recovery already ruled out."""
    tok = np.asarray(state[SPLIT_TOKEN])
    old = handler.visible(cfg, _split_state(state, "old/"))
    new = handler.visible(new_cfg, _split_state(state, "new/"))
    out: Dict[bytes, bytes] = {}
    for side, want_tok in ((old, 0), (new, 1)):
        ks = list(side.keys())
        if not ks:
            continue
        kn = np.frombuffer(b"".join(ks), np.uint32).reshape(-1, 4)
        homes = np.asarray(handler.route(cfg, kn, device)[0])
        for k, p in zip(ks, homes):
            if int(tok[int(p)]) == want_tok:
                out[k] = side[k]
    return out


@dataclasses.dataclass
class SplitSweep:
    """Exhaustive crash sweep of one incremental resize."""

    scheme: str
    moved: int
    cohorts: int
    crash_points: int
    torn_points: int
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


def split_crash_sweep(store, table, factor: int = 2,
                      include_torn: bool = True) -> SplitSweep:
    """Inject a crash at every PM-store boundary of the incremental
    resize (and every torn split), recover BOTH tables, resolve per-pair
    by token, and require the resolved set to equal the pre-resize item
    set at every point."""
    handler = HANDLERS[store.name]
    cfg = store.cfg
    new_cfg = cfg.grow(factor)
    base, trace = build_split_trace(store, table, factor)
    want = resolve_dual_read(handler, cfg, new_cfg, base, store.device)

    violations: List[str] = []
    merged = RecoveryReport(store.name)
    n_crash = n_torn = 0
    for cs in crash_states(base, trace, include_torn=include_torn):
        n_crash += 1
        n_torn += int(cs.torn)
        old_rec, r1 = handler.recover(cfg, _split_state(cs.state, "old/"))
        new_rec, r2 = handler.recover(new_cfg, _split_state(cs.state, "new/"))
        merged = merged.merge(r1).merge(r2)
        joined: State = {SPLIT_TOKEN: cs.state[SPLIT_TOKEN]}
        for f, v in old_rec.items():
            joined["old/" + f] = v
        for f, v in new_rec.items():
            joined["new/" + f] = v
        got = resolve_dual_read(handler, cfg, new_cfg, joined, store.device)
        if got != want:
            lost = sum(1 for k in want if got.get(k) != want[k])
            phantom = sum(1 for k in got if k not in want)
            violations.append(f"{cs.label}: resolved set diverged "
                              f"({lost} lost/torn, {phantom} phantom)")
    return SplitSweep(
        scheme=store.name, moved=len(want), cohorts=cfg.num_pairs,
        crash_points=n_crash, torn_points=n_torn, violations=violations,
        log_records_in_trace=trace.log_records(), report=merged)
