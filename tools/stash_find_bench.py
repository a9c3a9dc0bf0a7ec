#!/usr/bin/env python3
"""Times a stash-enabled continuity lookup and update on the card.

    PYTHONPATH=src python tools/stash_find_bench.py --label NAME \
        [--slots N] [--batch B] [--fill F] [--reps R]

Builds the port's continuity table of ``make_store("continuity",
table_slots=N)`` (the default 1/8 stash) on the card, fills it with
``F`` times its main slots of seeded random keys (so that the stash holds
live entries), then times ``continuity.lookup`` and
``continuity.update(probe="kernel")`` of batches of ``B`` keys (three
quarters resident, a quarter absent): the median of ``R`` calls each,
host clock between device synchronizes.  Where the package on the path
has the stash index (`continuity._stash_find`), it also counts the host
syncs of one index call (``torch.cuda.set_sync_debug_mode("warn")``) and
names the source line of each.
Prints one JSON line.  Whatever ``repro_torch`` is first on ``PYTHONPATH``
is timed, so two trees are compared by running this script once under
each, in one call to the card.
"""

import argparse
import json
import os
import statistics
import subprocess
import time
import warnings

import torch

from repro_torch import api
import repro_torch.core.continuity as ch


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _median_s(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--slots", type=int, default=1 << 20)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--fill", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stash_find_bench: needs a CUDA device")
    dev = "cuda"
    cfg = api.make_store("continuity", table_slots=a.slots,
                         device="cpu").cfg
    g = torch.Generator(device=dev).manual_seed(a.seed)
    n = int(a.fill * cfg.num_pairs * cfg.slots_per_pair)

    def words(m):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (m, 4), generator=g,
                             device=dev, dtype=torch.int32)

    K, V = words(n), words(n)
    t = ch.create(cfg, dev)
    t0 = time.perf_counter()
    for s in range(0, n, 1 << 22):
        ch.insert(cfg, t, K[s:s + (1 << 22)], V[s:s + (1 << 22)])
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    B = a.batch
    pick = torch.randint(0, n, (B - B // 4,), generator=g, device=dev)
    Q = torch.cat([K[pick], words(B // 4)])
    W = words(B)
    look_s = _median_s(lambda: ch.lookup(cfg, t, Q), a.reps)
    upd_s = _median_s(lambda: ch.update(cfg, t, Q, W, probe="kernel"),
                      a.reps)
    syncs = sites = None
    if hasattr(ch, "_stash_find"):
        pair, _ = ch.locate(cfg, Q)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True):  # a process's first
            torch.cuda.set_sync_debug_mode("warn")  # switch to "warn"
            torch.cuda.set_sync_debug_mode("default")   # reports a sync
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ch._stash_find(cfg, t, Q, pair)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sites = [f"{os.path.basename(w.filename)}:{w.lineno}"
                 for w in caught if "synchroniz" in str(w.message)]
        syncs = len(sites)
    print(json.dumps({
        "label": a.label, "card": _card(), "slots": a.slots,
        "num_pairs": cfg.num_pairs, "stash_slots": cfg.stash_slots,
        "filled": n, "stash_live": int((t.stash_meta != 0).sum()),
        "fill_s": t_fill, "batch": B, "reps": a.reps,
        "lookup_ms": 1e3 * look_s, "update_ms": 1e3 * upd_s,
        "stash_find_syncs": syncs, "sync_sites": sites}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
