"""The seeded chaos matrix: every scenario family x YCSB workloads.

Port of ``repro.chaos.matrix``; the grid, the payload, the gates and the
printout are the reference's, every cell's cluster on ``device`` (the
card unless the caller asks for the CPU).

    python -m repro_torch.chaos.matrix --smoke --seed 0 [--device cpu]
        [--json OUT.json] [--trace BASE]

runs the 14-cell grid below (storms incl. mid-join/mid-migration,
partitions with fencing, replica-lag reads, delivery faults, quorum-loss
and retry-exhaustion drills, churn soak — across YCSB A/B/C/E/F) and
gates the run on the aggregate invariants:

  * every cell's own checks hold (zero committed loss everywhere);
  * fencing completeness: EVERY injected stale ack was detected;
  * every transport retry path fired at least once somewhere in the
    grid — drop->timeout->backoff->replay, duplicate absorption,
    reorder re-sync, AND budget exhaustion (give-up -> un-acked round);
  * both degradation paths were observed (read-only write rejection,
    replica-lag read redirect).

Each cell's seed derives from the ONE --seed (seed*1000 + cell index),
and the JSON artifact echoes every cell's coordinates, so any failure
replays bit-exactly with `scenarios.run_scenario`.

Exit status 0 iff every gate holds.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

from repro_torch.chaos.scenarios import run_scenario

# the grid: (scenario, workload).  Workloads cover the read-heavy trio,
# E (short scans) and F (read-modify-write); every scenario family
# appears at least once.
GRID: Tuple[Tuple[str, str], ...] = (
    ("storm", "A"),
    ("storm", "E"),
    ("storm_mid_join", "B"),
    ("storm_mid_migration", "F"),
    ("partition_fence", "A"),
    ("partition_fence", "E"),
    ("partition_failover", "B"),
    ("lag_reads", "C"),
    ("delivery_faults", "A"),
    ("delivery_faults", "F"),
    ("read_only_degrade", "A"),
    ("timeout_giveup", "A"),
    ("soak", "B"),
    ("soak", "F"),
)


def run_matrix(seed: int = 0, scheme: str = "continuity",
               profile: str = "smoke", verbose: bool = True,
               device: str = "cuda") -> Dict:
    """Run the full grid; returns the artifact payload (cells + totals +
    gates + ok)."""
    cells: List[dict] = []
    for i, (scenario, workload) in enumerate(GRID):
        cell = run_scenario(scenario, scheme=scheme, workload=workload,
                            seed=seed * 1000 + i, profile=profile,
                            device=device)
        cells.append(cell)
        if verbose:
            bad = [k for k, v in cell["checks"].items() if not v]
            print(f"  [{i + 1:2d}/{len(GRID)}] {scenario:22s} x {workload}"
                  f"  seed={cell['seed']:<6d} "
                  f"{'ok' if cell['ok'] else 'FAIL ' + ','.join(bad)}")

    totals = {
        "committed_lost": sum(c["committed_lost"] for c in cells),
        "stale_acks_injected": sum(c["chaos"].get("stale_acks_injected", 0)
                                   for c in cells),
        "stale_acks_detected": sum(c["chaos"].get("stale_acks_detected", 0)
                                   for c in cells),
        "writes_rejected_read_only":
            sum(c["chaos"].get("writes_rejected_read_only", 0)
                for c in cells),
        "lag_read_redirects": sum(c["chaos"].get("lag_read_redirects", 0)
                                  for c in cells),
        "write_timeouts": sum(c["chaos"].get("write_timeouts", 0)
                              for c in cells),
        "retries": sum(c["wire"]["retries"] for c in cells),
        "duplicates": sum(c["wire"]["duplicates"] for c in cells),
        "reorders": sum(c["wire"]["reorders"] for c in cells),
        "backoff_us": sum(c["wire"]["backoff_us"] for c in cells),
        "give_ups": sum(c["wire"]["give_ups"] for c in cells),
    }
    gates = {
        "all_cells_ok": all(c["ok"] for c in cells),
        "zero_committed_loss": totals["committed_lost"] == 0,
        "stale_acks_all_detected":
            (totals["stale_acks_injected"] > 0
             and totals["stale_acks_detected"]
             == totals["stale_acks_injected"]),
        "retry_path_drop": totals["retries"] > 0,
        "retry_path_backoff": totals["backoff_us"] > 0,
        "retry_path_duplicate": totals["duplicates"] > 0,
        "retry_path_reorder": totals["reorders"] > 0,
        "retry_path_give_up": totals["give_ups"] > 0,
        "degradation_read_only": totals["writes_rejected_read_only"] > 0,
        "degradation_lag_redirect": totals["lag_read_redirects"] > 0,
    }
    return {
        "seed": seed, "scheme": scheme, "profile": profile,
        "grid_cells": len(cells), "cells": cells, "totals": totals,
        "gates": gates, "ok": all(gates.values()),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0,
                   help="grid seed; cell i runs at seed*1000+i")
    p.add_argument("--scheme", default="continuity")
    p.add_argument("--smoke", action="store_true",
                   help="CI sizes (the default profile is also smoke; "
                        "--full runs the larger grid)")
    p.add_argument("--full", action="store_true")
    p.add_argument("--json", default=None, help="write the artifact here")
    p.add_argument("--device", default="cuda",
                   help="where the node tables live (default: the card)")
    p.add_argument("--trace", default=None, metavar="BASE",
                   help="trace the grid under a deterministic TickClock "
                        "and write BASE.trace.json + BASE.metrics.json "
                        "(NOT gated by `repro_torch.obs.report --check` "
                        "for the baseline schemes — their blocking "
                        "resizes legitimately burn the maintenance SLO)")
    args = p.parse_args(argv)

    profile = "full" if args.full else "smoke"
    print(f"chaos matrix: {len(GRID)} cells, scheme={args.scheme}, "
          f"seed={args.seed}, profile={profile}")
    if args.trace:
        from repro_torch import obs
        with obs.scope(obs.Tracer(obs.TickClock())) as (tracer, reg):
            payload = run_matrix(seed=args.seed, scheme=args.scheme,
                                 profile=profile, device=args.device)
            tpath, mpath = obs.write_export(
                args.trace, tracer, reg,
                meta={"scheme": args.scheme, "seed": args.seed,
                      "profile": profile, "grid_cells": len(GRID)})
        payload["obs_export"] = {"trace": tpath, "metrics": mpath}
        print(f"obs export: {tpath} + {mpath}")
    else:
        payload = run_matrix(seed=args.seed, scheme=args.scheme,
                             profile=profile, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True, default=str)

    t = payload["totals"]
    print(f"totals: lost={t['committed_lost']} "
          f"stale={t['stale_acks_detected']}/{t['stale_acks_injected']} "
          f"retries={t['retries']:.0f} dups={t['duplicates']:.0f} "
          f"reorders={t['reorders']:.0f} give_ups={t['give_ups']:.0f} "
          f"rejected={t['writes_rejected_read_only']} "
          f"lag_redirects={t['lag_read_redirects']}")
    for gate, okv in payload["gates"].items():
        if not okv:
            print(f"FAIL gate: {gate}", file=sys.stderr)
    print("chaos matrix:", "PASS" if payload["ok"] else "FAIL")
    return 0 if payload["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
