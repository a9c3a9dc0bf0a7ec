#!/usr/bin/env python3
"""Where the host time of the fan-in drill goes, on the card or the CPU.

    PYTHONPATH=src python tools/fanin_profile.py [--device cuda|cpu] \
        [--clients C] [--top N]

Counts the torch operations of one routed read of 16 keys on a 4-node
continuity cluster loaded with the ``--smoke`` cell's 1,200 records
(``lookup_stamped``, ``version_read`` and the uncached edge's
``_uncached_round``; ``torch.profiler``, top-level ``aten::`` ops), then
runs the fan-in ``--smoke`` cell with ``C`` clients under ``cProfile``
after a two-client warm-up and prints its wall time and the ``N`` most
expensive functions by cumulative and by own time.  On the card every
counted op is a kernel launch, so the two views together say which
Python functions the host spends its time issuing.
"""

import argparse
import cProfile
import collections
import pstats
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.cache import fanin
from repro_torch.cluster.store import ClusterStore
from repro_torch.data import ycsb


def op_counts(device: str) -> dict:
    """Top-level aten ops per routed read of 16 keys, by read kind."""
    kw = fanin.smoke_kwargs(True)
    n = kw["num_records"]
    cluster = ClusterStore("continuity", nodes=4, replicas=2,
                           node_slots=int(n * 2 / 4 * 2.5) + 256,
                           device=device)
    cluster.insert(ycsb.make_key(np.arange(n)),
                   ycsb.make_value(np.random.RandomState(0), n))
    keys = ycsb.make_key(np.arange(16) * 7)
    reads = {"lookup_stamped": lambda: cluster.lookup_stamped(keys),
             "version_read": lambda: cluster.version_read(keys),
             "uncached_round": lambda: fanin._uncached_round(cluster, keys,
                                                             {})}
    out = {}
    for name, fn in reads.items():
        fn()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        ops = [e.name for e in prof.events()
               if e.name.startswith("aten::") and e.cpu_parent is None]
        out[name] = (len(ops), collections.Counter(ops).most_common(6))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--clients", type=int, default=40)
    p.add_argument("--top", type=int, default=30)
    args = p.parse_args(argv)
    if args.device == "cuda":
        from repro_torch.kernels import _cuda
        _cuda.build_all()
        print(torch.cuda.get_device_name(0))
    for name, (n, top) in op_counts(args.device).items():
        print(f"{name}: {n} top-level torch ops for 16 keys on 4 nodes; "
              f"most frequent {top}")
    kw = dict(fanin.smoke_kwargs(True), clients=args.clients)
    fanin.run_fanin(device=args.device, **dict(kw, clients=2, rounds=2))
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fanin.run_fanin(device=args.device, **kw)
    prof.disable()
    print(f"fan-in --smoke with {args.clients} clients on {args.device}: "
          f"{time.perf_counter() - t0:.3f} s")
    stats = pstats.Stats(prof, stream=sys.stdout)
    stats.sort_stats("cumulative").print_stats(args.top)
    stats.sort_stats("tottime").print_stats(args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
