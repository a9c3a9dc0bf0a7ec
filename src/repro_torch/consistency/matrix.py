"""The crash/scheme matrix: every scheme x insert/update/delete (plus the
cluster's live-migration cell and the incremental-resize cell), swept
through every crash point — the gate for the consistency subsystem.  Port of ``repro.consistency.matrix``; the
stores live on ``--device`` (the card unless asked for the CPU) and each
row equals the reference's.

Each cell traces a small batch against a pre-loaded store, injects a crash
at every PM-store boundary (plus every torn split of non-atomic stores),
runs the scheme's recovery, and checks atomic per-op visibility
(`repro_torch.consistency.checker`).  The ``migrate`` cell sweeps a live
shard migration (dest copies -> token cutover -> source deletes,
`repro_torch.cluster.migration`) the same way: dual-read resolution must
equal the original item set at EVERY crash prefix, with zero migration
log.  The ``resize`` cell sweeps the online split (cohort copies -> token
cutover -> source deletes, `repro_torch.consistency.split`) likewise, with
zero resize log.  Expectations encode the paper's contrast:

  * ``continuity`` — consistent at every crash point with ZERO log
    records (trace contains none, recovery reads none);
  * ``level``      — consistent; the in-place update fallback must
    exercise the undo log (shapes force a full bucket);
  * ``pfarm``      — consistent; EVERY op is RECIPE-logged, so recovery
    must replay log records at mid-op crash points;
  * ``dense``      — insert/delete consistent (split commit); update is
    the documented negative control: an unprotected in-place store whose
    torn states MUST be detected by the checker (proving the checker can
    see real corruption — a built-in mutation test).

Usage:  python -m repro_torch.consistency.matrix [--device cpu]
            [--json OUT.json] [--quiet]
Exit status 0 iff every cell matches its expectation.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Tuple

import numpy as np

from repro_torch import api
from repro_torch.consistency.checker import CaseResult, run_case
from repro_torch.data import ycsb

OPS = ("insert", "update", "delete")
MIGRATE_SCHEMES = ("continuity",)   # schemes the migrate cell sweeps
RESIZE_SCHEMES = ("continuity",)    # schemes the incremental-resize cell sweeps

# (consistent, log_free) expected per cell; None = don't-care
EXPECT: Dict[Tuple[str, str], Tuple[bool, bool]] = {
    ("continuity", "migrate"): (True, True),
    ("continuity", "resize"): (True, True),
    ("continuity", "insert"): (True, True),
    ("continuity", "update"): (True, True),
    ("continuity", "delete"): (True, True),
    ("level", "insert"): (True, True),
    ("level", "update"): (True, False),   # logged fallback must trigger
    ("level", "delete"): (True, True),
    ("pfarm", "insert"): (True, False),
    ("pfarm", "update"): (True, False),
    ("pfarm", "delete"): (True, False),
    ("dense", "insert"): (True, True),
    ("dense", "update"): (False, True),   # torn in-place update DETECTED
    ("dense", "delete"): (True, True),
}

# per-scheme (table_slots, base_items, batch): level runs near-full so the
# update batch hits a full bucket (the logged in-place fallback)
SHAPES: Dict[str, Tuple[int, int, int]] = {
    "continuity": (240, 24, 8),
    "level": (48, 36, 10),
    "pfarm": (96, 20, 8),
    "dense": (64, 24, 8),
}


def _load(scheme: str, device="cuda"):
    slots, n_base, n_ops = SHAPES[scheme]
    store = api.make_store(scheme, table_slots=slots, device=device)
    rng = np.random.RandomState(7)
    K = ycsb.make_key(np.arange(n_base))
    V = ycsb.make_value(rng, n_base)
    table = store.create()
    table, res = store.insert(table, K, V)
    okn = res.ok.cpu().numpy()
    return store, table, K[okn], n_ops, rng


def run_cell(scheme: str, op: str, order: str = "serial",
             device="cuda") -> CaseResult:
    store, table, live_keys, n_ops, rng = _load(scheme, device)
    n = min(n_ops, live_keys.shape[0])
    if op == "insert":
        keys = ycsb.make_key(np.arange(1000, 1000 + n))
        vals = ycsb.make_value(rng, n)
    else:
        keys = live_keys[:n]
        vals = ycsb.make_value(rng, n) if op == "update" else None
    return run_case(store, table, op, keys, vals, order=order)


def run_matrix(schemes=None, ops=OPS, order: str = "serial",
               device="cuda") -> List[CaseResult]:
    """The scheme x write-op cells.  The migrate cell has a different
    result shape (a summary dict, not a `CaseResult`) — ask for it via
    `run_migration_cell` / `run_rows`, not here."""
    for special in ("migrate", "resize"):
        if special in ops:
            raise ValueError(
                f"run_matrix sweeps write ops only; use "
                f"run_{'migration' if special == 'migrate' else special}"
                f"_cell (or run_rows) for {special}")
    schemes = schemes or [s for s in api.available_schemes() if s in SHAPES]
    return [run_cell(s, op, order, device) for s in schemes for op in ops]


def run_rows(schemes=None, ops=OPS + ("migrate", "resize"),
             order: str = "serial", device="cuda") -> List[dict]:
    """Summary rows for every requested cell, migrate and resize included
    — the ONE inventory the CLI and library callers share."""
    rows = [summarize(r) for r in
            run_matrix(schemes,
                       tuple(o for o in ops
                             if o not in ("migrate", "resize")), order,
                       device)]
    if "migrate" in ops:
        rows += [run_migration_cell(s, device=device)
                 for s in MIGRATE_SCHEMES
                 if schemes is None or s in schemes]
    if "resize" in ops:
        rows += [run_resize_cell(s, device=device) for s in RESIZE_SCHEMES
                 if schemes is None or s in schemes]
    return rows


def run_migration_cell(scheme: str, n_move: int = 6,
                       device="cuda") -> dict:
    """The cluster's live-migration crash cell: sweep every crash prefix
    of dest-copy -> token-cutover -> source-delete and require the
    dual-read-resolved item set to equal the original at every point
    (`repro_torch.cluster.migration.migration_crash_sweep`)."""
    from repro_torch.cluster.migration import migration_crash_sweep
    store, src_table, _, _, _ = _load(scheme, device)
    keys, vals, live = store._extract(src_table)
    K = keys[live].cpu().numpy().view(np.uint32)[:n_move]
    V = vals[live].cpu().numpy().view(np.uint32)[:n_move]
    sweep = migration_crash_sweep(store, src_table, store.create(), K, V)
    want = EXPECT.get((scheme, "migrate"), (None, None))
    ok = ((want[0] is None or want[0] == sweep.consistent)
          and (want[1] is None or want[1] == sweep.log_free))
    return {
        "scheme": scheme, "op": "migrate", "order": "serial",
        "paths": ["migrate"],
        "crash_points": sweep.crash_points,
        "torn_points": sweep.torn_points,
        "violations": len(sweep.violations),
        "consistent": sweep.consistent, "log_free": sweep.log_free,
        "trace_log_records": sweep.log_records_in_trace,
        "log_used_points": int(sweep.report.log_records_used > 0),
        "recovery": dataclasses.asdict(sweep.report),
        "expected": list(want),
        "ok": ok,
    }


def run_resize_cell(scheme: str, factor: int = 2, device="cuda") -> dict:
    """The incremental-resize crash cell: sweep every crash prefix of the
    per-cohort copy -> token-cutover -> cleanup trace and require the
    dual-read-resolved item set to equal the original at every point,
    with zero resize log (`repro_torch.consistency.split.split_crash_sweep`)."""
    from repro_torch.consistency.split import split_crash_sweep
    store, table, _, _, _ = _load(scheme, device)
    sweep = split_crash_sweep(store, table, factor)
    want = EXPECT.get((scheme, "resize"), (None, None))
    ok = ((want[0] is None or want[0] == sweep.consistent)
          and (want[1] is None or want[1] == sweep.log_free))
    return {
        "scheme": scheme, "op": "resize", "order": "serial",
        "paths": ["resize"],
        "crash_points": sweep.crash_points,
        "torn_points": sweep.torn_points,
        "violations": len(sweep.violations),
        "consistent": sweep.consistent, "log_free": sweep.log_free,
        "trace_log_records": sweep.log_records_in_trace,
        "log_used_points": int(sweep.report.log_records_used > 0),
        "recovery": dataclasses.asdict(sweep.report),
        "expected": list(want),
        "ok": ok,
    }


def cell_ok(r: CaseResult) -> bool:
    want = EXPECT.get((r.scheme, r.op))
    if want is None:
        return True
    want_consistent, want_log_free = want
    if want_consistent != r.consistent:
        return False
    if want_log_free is not None and want_log_free != r.log_free:
        return False
    if not r.consistent and not any("torn" in v for v in r.violations):
        return False          # negative control must come from TORN stores
    return True


def summarize(r: CaseResult) -> dict:
    return {
        "scheme": r.scheme, "op": r.op, "order": r.order,
        "paths": sorted(set(r.paths)),
        "crash_points": r.crash_points, "torn_points": r.torn_points,
        "violations": len(r.violations),
        "consistent": r.consistent, "log_free": r.log_free,
        "trace_log_records": r.log_records_in_trace,
        "log_used_points": r.log_used_points,
        "recovery": dataclasses.asdict(r.report),
        "expected": list(EXPECT.get((r.scheme, r.op), (None, None))),
        "ok": cell_ok(r),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--schemes", default=None,
                   help="comma-separated subset (default: all registered)")
    p.add_argument("--ops", default=",".join(OPS + ("migrate", "resize")))
    p.add_argument("--device", default="cuda",
                   help="where the stores live (default: the card)")
    p.add_argument("--json", default=None, help="write cell summaries here")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)
    schemes = args.schemes.split(",") if args.schemes else None
    rows = run_rows(schemes, tuple(args.ops.split(",")),
                    device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
    bad = [r for r in rows if not r["ok"]]
    if not args.quiet:
        hdr = (f"{'scheme':<11} {'op':<7} {'crash':>5} {'torn':>5} "
               f"{'viol':>5} {'log':>4} {'dup':>4}  verdict")
        print(hdr)
        print("-" * len(hdr))
        for r in rows:
            print(f"{r['scheme']:<11} {r['op']:<7} {r['crash_points']:>5} "
                  f"{r['torn_points']:>5} {r['violations']:>5} "
                  f"{r['log_used_points']:>4} "
                  f"{r['recovery']['duplicates_cleared']:>4}  "
                  f"{'PASS' if r['ok'] else 'FAIL'}")
        n = sum(r["crash_points"] for r in rows)
        print(f"\n{len(rows)} cells, {n} crash states injected; "
              f"{len(bad)} unexpected")
    for r in bad:
        print(f"FAIL {r['scheme']}/{r['op']}: consistent={r['consistent']} "
              f"log_free={r['log_free']} expected={r['expected']}",
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
