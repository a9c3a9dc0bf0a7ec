#!/usr/bin/env python3
"""YCSB-C through the JAX reference's end-to-end simulator, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_ycsb_c.py

Runs ``repro.rdma.sim.run_ycsb`` (the reference package, not the port) for
continuity and level on YCSB-C at 1,048,576 records, 262,144 ops and
batches of 4,096 (the sizes of ``chip_smoke.py``'s ``E2E_LARGE``), and
prints each cell's simulated results with its wall time as one JSON line.
The simulated numbers are ``LinkModel`` outputs: deterministic, so they
compare exactly with the port's run of the same cells on the card.
"""

import json
import sys
import time

from repro.rdma import sim

CELL = dict(num_records=1_048_576, num_ops=262_144, batch=4_096)


def main() -> int:
    for scheme in sys.argv[1:] or ("continuity", "level"):
        t0 = time.perf_counter()
        res = sim.run_ycsb(scheme, "C", **CELL)
        print(json.dumps({"scheme": scheme, "workload": "C", **CELL,
                          **{k: float(v) for k, v in res.items()},
                          "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
