"""Readings behind the limits of ``correct``: the program over many seeds,
and the control, on the chip at a cell's own size.

    python3 portbench/control.py --workload <name> --seeds 11 12 13 \
        [--seconds 2] [--control] [--trace 0|1] [--out FILE]

Runs the cell once per seed in this one process (set-up repeated per
seed, the window ``--seconds`` long; a served model's window is one group
with no warm-up group) and prints one JSON line per seed: the numbers
compared with their limits, and the runner's facts.  With ``--control``
the control runs too: for a store configuration the read path without
its extension and stash tails (``plants.drop_tails``), for a served model
the fp8 reference's first-choice tokens judged in the served tokens'
place (``checks.logit_gap``), the served tokens' own gap beside it
(``facts.program_gap``).  Never run by the benchmark's runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness
    bench = harness.manifest()
    w = harness.find(bench["workloads"], args.workload, "workload")
    c = harness.find(bench["configs"], w["config"], "config")
    runner = harness.load_json(harness.config_file(c))["runner"]
    plant, overrides = (), {}
    if runner == "serve":
        overrides = {"traffic": {"warmup_groups": 0}}
        plant = ("fp8_control",) if args.control else ()
    elif args.control:
        plant = ("drop_tails",)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t = time.perf_counter()
        line = harness.run_cell(args.workload, seed, args.seconds,
                                bool(args.trace), "cuda", t_start=t,
                                bench=bench,
                                overrides=overrides, plant=plant,
                                with_facts=True)
        rec = {"workload": args.workload, "seed": seed, "plant": plant,
               "correct": line["correct"], "checks": line["checks"],
               "metrics": line["metrics"],
               "facts": line["facts"],
               "seconds": time.perf_counter() - t}
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
