"""The multi-device layer across several ranks: the cards of one host
(NCCL, one process per card) or gloo ranks on the CPU.

    python3 tools/multidevice_cards.py                    # 4 cards, full size
    python3 tools/multidevice_cards.py --device cpu --buckets 12 --smoke

Spawns one process per rank.  (a) The sharded continuity store
(``core.distributed``) at 2^buckets buckets, one shard per rank: seeded
records to load factor 0.6 of the segment slots written through
``make_write`` (each rank its slice of every global batch of ranks x
65,536), every record and 65,536 absent keys per rank read back through
``make_lookup``; every acknowledged record must read back, no refused or
absent one, and rank 0 holds the found set and values against an
unsharded ``ContinuityStore`` loaded with the acknowledged records.
(b) Yi-6B cut to 8 layers (``--smoke``: its smoke twin with 2 kv heads),
2 x 4,096 tokens (64 with ``--smoke``), 2 AdamW steps on a (ranks / 2, 2)
``("data", "model")`` mesh against the same steps unsharded on rank 0's
device: loss
within 1e-3 and every leaf within atol 2e-4 / rtol 2e-3 (the JAX package's
``tests/test_distributed.py`` tolerances).  Prints one JSON line of the
timings and checks; exits non-zero if a check fails.
"""

import argparse
import dataclasses
import json
import socket
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

PER_RANK = 65_536              # client batch per rank (write and read)
LOSS_TOL, ATOL, RTOL = 1e-3, 2e-4, 2e-3
STEPS = 2


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _store(torch, dist, rank, world, dev, buckets) -> dict:
    from repro_torch import api
    from repro_torch.core import continuity as ch
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_debug_mesh
    scfg = D.StoreConfig(table=ch.ContinuityConfig(num_buckets=2 ** buckets,
                                                   ext_frac=0.0),
                         num_shards=world)
    mesh = make_debug_mesh((world,), ("data",), device_type=dev.type)
    write, lookup = D.make_write(scfg, mesh), D.make_lookup(scfg, mesh)
    table = D.create_sharded(scfg, dev)
    gen = torch.Generator(dev).manual_seed(11)      # the same on every rank
    N = int(0.6 * 2 ** buckets * 8)
    keys = torch.randint(-2 ** 31, 2 ** 31, (N, 4), dtype=torch.int32,
                         generator=gen, device=dev)
    vals = torch.randint(-2 ** 31, 2 ** 31, (N, 4), dtype=torch.int32,
                         generator=gen, device=dev)
    step = world * PER_RANK
    pad = (-N) % step                 # the last global batch, padded no-ops
    zk = torch.zeros((pad, 4), dtype=torch.int32, device=dev)
    gk, gv = torch.cat([keys, zk]), torch.cat([vals, zk])
    gop = torch.cat([torch.full((N,), D.OP_INSERT, dtype=torch.int32,
                                device=dev),
                     torch.zeros(pad, dtype=torch.int32, device=dev)])

    def mine(t, s):
        return t[s + rank * PER_RANK:s + (rank + 1) * PER_RANK]
    ok = torch.empty(N + pad, dtype=torch.bool, device=dev)
    routed = torch.empty_like(ok)
    dist.barrier()
    t0 = time.perf_counter()
    for s in range(0, N + pad, step):
        _, o, r = write(table, mine(gop, s), mine(gk, s), mine(gv, s))
        parts = [torch.empty_like(o) for _ in range(world)]
        dist.all_gather(parts, o)
        ok[s:s + step] = torch.cat(parts)
        dist.all_gather(parts, r)
        routed[s:s + step] = torch.cat(parts)
    _sync(torch, dev)
    dist.barrier()
    t_load = time.perf_counter() - t0
    ok, routed = ok[:N], routed[:N]
    acked = int(ok.sum())
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    bad += int(not bool(routed.all()))
    t0 = time.perf_counter()
    for s in range(0, N + pad, step):
        r = lookup(table, mine(gk, s))
        lo = s + rank * PER_RANK
        n = max(0, min(PER_RANK, N - lo))
        bad += (r.found[:n] != ok[lo:lo + n]).sum()
        hit = r.found[:n]
        bad += (r.values[:n][hit] != gv[lo:lo + n][hit]).any(-1).sum()
    absent = torch.randint(-2 ** 31, 2 ** 31, (PER_RANK, 4), dtype=torch.int32,
                           generator=torch.Generator(dev).manual_seed(
                               100 + rank), device=dev)
    neg = lookup(table, absent)
    bad += neg.found.sum()
    _sync(torch, dev)
    dist.barrier()
    t_read = time.perf_counter() - t0
    count = int(D.sharded_count(table))
    bad += int(count != acked)
    dist.all_reduce(bad)
    out = {"store_ranks": world, "buckets": 2 ** buckets, "records": N,
           "acked": acked, "load_s": t_load, "read_s": t_read,
           "store_mismatches": int(bad),
           "ledger_reads": int(neg.ledger.rdma_reads)}
    del table
    if rank == 0:                     # the unsharded store of the same geometry
        store = api.make_store("continuity", num_buckets=2 ** buckets,
                               ext_frac=0.0, stash_frac=0.0,
                               device=str(dev))
        flat = store.create()
        _, res = store.insert(flat, keys[ok], vals[ok])
        miss = int((~res.ok).sum())
        for s in range(0, N, 2 ** 20):
            res = store.lookup(flat, keys[s:s + 2 ** 20])
            miss += int((res.ok != ok[s:s + 2 ** 20]).sum())
            hit = res.ok
            miss += int((res.values[hit] != vals[s:s + 2 ** 20][hit]).any(-1)
                        .sum())
        out["unsharded_mismatches"] = miss
    dist.barrier()
    return out


def _train(torch, dist, rank, world, dev, smoke) -> dict:
    import numpy as np
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.distribution import sharding as SH
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step, place_state
    # the smoke twin with 2 kv heads, so that the model axis shards them as
    # it shards Yi-6B's 4 at full width
    cfg = (dataclasses.replace(smoke_config("yi-6b"), n_kv_heads=2) if smoke
           else dataclasses.replace(get_arch("yi-6b"), n_layers=8,
                                    remat="full"))
    seq = 64 if smoke else 4_096
    opt = O.OptConfig(lr=1e-5, warmup=2, decay_steps=100)
    step = make_train_step(cfg, opt)
    rng = np.random.RandomState(7)
    toks = rng.randint(0, cfg.vocab, (2, seq)).astype(np.int32)
    batch = {"inputs": torch.from_numpy(toks).to(dev),
             "labels": torch.from_numpy(np.roll(toks, -1, 1)).to(dev)}

    def fresh():
        return T.init_params(cfg, torch.Generator(dev).manual_seed(0),
                             master_dtype=torch.float32)
    ref, ref_loss, ref_s = None, [], []
    if rank == 0:                     # the unsharded steps, on this device
        p = fresh()
        s = O.init(p)
        for _ in range(STEPS):
            _sync(torch, dev)
            t0 = time.perf_counter()
            p, s, st = step(p, s, batch)
            ref_loss.append(float(st["loss"]))
            _sync(torch, dev)
            ref_s.append(time.perf_counter() - t0)
        ref = {k: t.cpu() for k, t in O.leaves(p)}
        del p, s
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_debug_mesh((world // 2, 2), ("data", "model"),
                           device_type=dev.type)
    losses, times = [], []
    with SH.use_mesh(mesh):
        start = fresh()
        p, s = place_state(cfg, opt, start, O.init(start))
        del start
        for _ in range(STEPS):
            _sync(torch, dev)
            dist.barrier()
            t0 = time.perf_counter()
            p, s, st = step(p, s, batch)
            losses.append(float(st["loss"]))
            _sync(torch, dev)
            times.append(time.perf_counter() - t0)
        placed = str(tuple(p["blocks"]["wq"].placements))
        worst = 0.0
        for k, leaf in O.leaves(p):
            full = leaf.full_tensor()
            if rank == 0:
                a = ref[k].to(dev)
                d = (full - a).abs() - RTOL * a.abs()
                worst = max(worst, float(d.max()))
            del full
    out = {"train_mesh": [world // 2, 2], "wq_placed": placed,
           "losses": losses, "unsharded_losses": ref_loss,
           "step_s": times, "unsharded_step_s": ref_s,
           "worst_leaf_excess": worst}
    return out


def _rank(rank, world, port, args, queue):
    import torch
    import torch.distributed as dist
    dev = (torch.device("cuda", rank) if args.device == "cuda"
           else torch.device("cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(2)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        out = _store(torch, dist, rank, world, dev, args.buckets)
        out.update(_train(torch, dist, rank, world, dev, args.smoke))
        if rank == 0:
            queue.put(("ok", out))
    except BaseException:
        # the other ranks would wait in their next collective: the parent
        # ends them all on the first error
        queue.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--buckets", type=int, default=22)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"multidevice_cards: {args.ranks} cards needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_rank, args=(r, args.ranks, port, args,
                                             queue))
             for r in range(args.ranks)]
    for p in procs:
        p.start()
    status, out = "timeout", "no rank reported within 1,500 s"
    try:
        status, out = queue.get(timeout=1_500)
    finally:
        for p in procs:
            p.join(timeout=120 if status == "ok" else 1)
            if p.is_alive():
                p.terminate()
                p.join()
    if status != "ok":
        print(out, file=sys.stderr)
        return 1
    out["seconds"] = time.perf_counter() - t0
    if args.device == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    ok = (out["store_mismatches"] == 0 and out["unsharded_mismatches"] == 0
          and all(abs(a - b) < LOSS_TOL for a, b in
                  zip(out["losses"], out["unsharded_losses"]))
          and out["worst_leaf_excess"] <= ATOL
          and all(p.exitcode == 0 for p in procs))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
