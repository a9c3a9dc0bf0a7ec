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
``tests/test_distributed.py`` tolerances).  (c) Yi-6B's paged serving
(``chip_smoke.py`` phase 5's bf16 weights at full width, 32 prompts of
2,048 tokens, page size 16; ``--smoke``: the smoke twin with 2 kv heads, 4
prompts of 32 tokens) on a (ranks / 2, 2) mesh: 2 data shards, each page's
16 tokens split 8 / 8 over the model axis, attention through the kernel's
slice mode and the partials' exchange; the same run unsharded on rank
0's device.  Held: every rank's page tables and sequence fields equal
the unsharded run's for its data shard, byte for byte; each layer's
slice-mode attention of one bf16 step within ``chip_smoke``'s bf16 limit
of the plain version on the same inputs; a float32 twin (4 sequences,
256-token prompts, 7 steps fed the unsharded run's tokens) within atol
1e-4 / rtol 1e-4 of the unsharded logits.  Recorded, not gated: ms per
bf16 decode step against one card's, the greedy tokens' agreement.
Prints one JSON line of the timings and checks; exits non-zero if a
check fails.
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
sys.path.insert(0, str(ROOT))

PER_RANK = 65_536              # client batch per rank (write and read)
LOSS_TOL, ATOL, RTOL = 1e-3, 2e-4, 2e-3
STEPS = 2
SERVE_TOL = 1e-4               # the float32 twin's logits, atol and rtol
SERVE_GEN = 8                  # generated tokens: the prefill's + 7 steps


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


def _serve_cfg(smoke):
    from repro_torch.configs import get_arch, smoke_config
    if smoke:        # 2 kv heads, as _train's twin; bf16 as the served model
        return dataclasses.replace(smoke_config("yi-6b"), n_kv_heads=2,
                                   dtype="bfloat16")
    return get_arch("yi-6b")


def _table_state(cache) -> dict:
    """A paged cache's page tables and sequence fields, host numpy."""
    from repro_torch import convert
    st = convert.cache_to_numpy(cache)
    out = {f: st[f] for f in ("next_free", "seq_ids", "seq_lens", "cur_page",
                              "cur_off")}
    out.update({f"table.{k}": v for k, v in st["table"].items()})
    return out


def _slice_checks(K, errs):
    """``ops.paged_attention`` wrapped so that every slice-mode call is also
    run by the plain version on the same operands: each appends (max abs
    difference of the slice's own merged output, its limit)."""
    import chip_smoke
    from repro_torch.kernels.paged_attn_ref import merge_partials_ref
    kernel_call = K.paged_attention

    def both(*a, **kw):
        out = kernel_call(*a, **kw)
        if kw.get("page_stride") is not None:
            want = merge_partials_ref(*kernel_call(*a, use_kernel=False,
                                                   **kw), a[0].dtype).float()
            got = K.merge_partials(*out, a[0].dtype).float()
            errs.append((float((got - want).abs().max()),
                         chip_smoke._attn_limit(want)))
        return out
    return kernel_call, both


def _serve(torch, dist, rank, world, dev, smoke) -> dict:
    import chip_smoke
    import numpy as np
    from repro_torch.distribution import sharding as SH
    from repro_torch.kernels import ops as K
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    from repro_torch.serving import kvcache as KC
    cfg = _serve_cfg(smoke)
    B, P = (4, 32) if smoke else (chip_smoke.SERVE_B, chip_smoke.PROMPT_LEN)
    PS, DS = chip_smoke.PAGE_SIZE, world // 2
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(0))
    chip_smoke._scale_residuals(cfg, params)
    for t in [*params["blocks"].values()] + [v for k, v in params.items()
                                              if k != "blocks"]:
        dist.broadcast(t, src=0)      # rank 0's draw on every rank
    prompts = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (B, P)).astype(np.int32)).to(dev)
    mesh = make_debug_mesh((DS, 2), ("data", "model"), device_type=dev.type)

    def geometry(c, b, p):
        return serve.make_geometry(c, b, p, SERVE_GEN, page_size=PS,
                                   shards=DS, device=str(dev))
    out = {"serve_mesh": [DS, 2], "serve_batch": B, "prompt": P}
    # bf16: the launcher's prefill and greedy decode, unsharded on rank 0
    geom = geometry(cfg, B, P)
    ref = {}
    if rank == 0:
        with chip_smoke._StepLog(torch, timed=dev.type == "cuda") as log:
            lg, cache = serve.run_prefill(cfg, geom, params, prompts,
                                          KC.create_cache(geom))
            toks, _, cache = serve.run_decode(cfg, geom, params, lg, cache,
                                              SERVE_GEN)
        ref = {"toks": toks.cpu(), "state": _table_state(cache),
               "step_ms": [t * 1e3 for t in log.times]}
        del cache
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    errs = []
    with SH.use_mesh(mesh):
        p = SH.distribute(params, T.param_logical_axes(cfg, params))
        lgeom, cache = KC.shard_cache(geom, KC.create_cache(geom))
        with chip_smoke._StepLog(torch, timed=dev.type == "cuda") as log:
            lg, cache = serve.run_prefill(cfg, lgeom, p, prompts, cache)
            toks, lg, cache = serve.run_decode(cfg, lgeom, p, lg, cache,
                                               SERVE_GEN - 1)
        kernel_call, K.paged_attention = _slice_checks(K, errs)
        try:             # one more step, every slice-mode call checked
            _, cache = E.serve_step(cfg, lgeom, p,
                                    lg.argmax(-1).to(torch.int32), cache)
        finally:
            K.paged_attention = kernel_call
        mine = _table_state(cache)
        slice_of = [lgeom.page_slice, lgeom.page_slices, lgeom.token_offset]
    del cache, p
    states = [None] * world
    dist.all_gather_object(states, (rank, mine, slice_of))
    out.update(step_ms=[t * 1e3 for t in log.times])
    if rank == 0:
        bad = []
        for r, st, sl in states:
            ds = r // 2
            for k, v in st.items():
                if not np.array_equal(v, ref["state"][k][ds:ds + 1]):
                    bad.append(f"rank {r} {k}")
        out.update(unsharded_step_ms=ref["step_ms"], table_mismatches=bad,
                   slices=[sl for _, _, sl in states],
                   greedy_agreement=float(
                       (toks.cpu()[:, :SERVE_GEN - 1]
                        == ref["toks"][:, :SERVE_GEN - 1]).float().mean()))
    out["attention_worst"] = max(errs, key=lambda el: el[0] / el[1])
    out["attention_checked"] = len(errs)
    out["attention_ok"] = all(e <= lim for e, lim in errs)
    # the float32 twin at phase 5's float32-twin shape, fed the unsharded
    # run's tokens
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = {k: v.float() for k, v in params.items() if k != "blocks"}
    p32["blocks"] = {k: v.float() for k, v in params["blocks"].items()}
    del params
    B32, P32 = (4, 32) if smoke else (chip_smoke.CHECK_SEQS, 256)
    g32 = geometry(cfg32, B32, P32)
    feed = torch.zeros((B32, SERVE_GEN - 1), dtype=torch.int32, device=dev)
    want = []
    if rank == 0:
        lg, c = serve.run_prefill(cfg32, g32, p32, prompts[:B32, :P32],
                                  KC.create_cache(g32))
        toks, _, c = serve.run_decode(cfg32, g32, p32, lg, c, SERVE_GEN)
        feed.copy_(toks[:, :SERVE_GEN - 1])
        del c
    dist.broadcast(feed, src=0)
    if rank == 0:                     # the same steps, logits kept
        lg, c = E.prefill(cfg32, g32, p32, prompts[:B32, :P32],
                          KC.create_cache(g32))
        want.append(lg)
        for i in range(SERVE_GEN - 1):
            lg, c = E.serve_step(cfg32, g32, p32, feed[:, i], c)
            want.append(lg)
        del c
    got = []
    with SH.use_mesh(mesh):
        p = SH.distribute(p32, T.param_logical_axes(cfg32, p32))
        lgeom, c = KC.shard_cache(g32, KC.create_cache(g32))
        lg, c = E.prefill(cfg32, lgeom, p, prompts[:B32, :P32], c)
        got.append(lg)
        for i in range(SERVE_GEN - 1):
            lg, c = E.serve_step(cfg32, lgeom, p, feed[:, i], c)
            got.append(lg)
        del c, p
    if rank == 0:
        out["f32_excess"] = max(float(((a - b).abs() - SERVE_TOL
                                       - SERVE_TOL * b.abs()).max())
                                for a, b in zip(got, want))
        out["f32_max_abs"] = max(float((a - b).abs().max())
                                 for a, b in zip(got, want))
    dist.barrier()
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
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out.update(_serve(torch, dist, rank, world, dev, args.smoke))
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
          and not out["table_mismatches"] and out["attention_ok"]
          and out["f32_excess"] <= 0
          and all(p.exitcode == 0 for p in procs))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
