#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the continuity store on one card.

    python3 chip_smoke.py

Phases, in order:

1. Header: the card's name and power limit, torch and CUDA versions, and
   the build of the CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. Kernel vs plain: a table of the paper's geometry at full size (2**23
   buckets: 16 B keys and values, 4-slot buckets, 3 SBuckets, 10 %
   extension pool, no stash) loaded with 50,331,648 YCSB records (load
   factor 0.6); each kernel held against its plain PyTorch version on it
   (exact integer equality) and on synthetic rows, and timed beside its
   bound; the card's store held against the CPU store on a small input.
3. Main path, with every kernel's launch count set to 0 just before:
   ``make_store("continuity", ...)`` on ``cuda`` bulk-loads the same
   records in 48 insert batches, reads every acknowledged key back,
   looks up absent keys, runs YCSB-A read/update batches, a distinct-key
   update and delete batch (paper Table I: 2 / 2 / 1 PM writes per op),
   and compares the kernel lookup policy with the gather policy.
4. Report: one JSON line of every kernel's launches on the main path,
   error, times and bound; the card's name and power limit; last
   ``{"ok": true, "device": {...}}``.

Any failed check raises.  Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

NUM_BUCKETS = 2 ** 23          # 4,194,304 segment pairs, 83.9 M main slots
N_RECORDS = 50_331_648         # load factor 0.6
LOAD_BATCH = 2 ** 20           # 48 insert batches
READ_BATCH = 2 ** 20
QUERY_B = 65_536               # kernel comparison and YCSB batch size
ODD_B = 65_531
YCSB_BATCHES = 4
SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device-memory rate (data sheet)
KERNEL_SLEEP = 40_000_000      # device-sleep cycles ahead of a timed kernel
PLAIN_SLEEP = 200_000_000     # ... of a timed plain version (~100 ms)


def _check(cond, what: str) -> None:
    if not bool(cond):
        raise AssertionError(f"check failed: {what}")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _timed(torch, fn):
    """(result, seconds) of ``fn()`` ending in a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _event_ms(torch, fn, batches, iters):
    """Mean milliseconds per call of ``fn(batch)`` called back to back from
    Python, cycling through ``batches`` (distinct query sets, so the rows
    of one call are not left in L2 by the previous one): what a caller
    pays, host overhead included."""
    for b in batches[:2]:
        fn(b)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(batches[i % len(batches)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, batches, iters, sleep_cycles):
    """Mean device milliseconds of ``fn(batch)``: each call is enqueued
    behind a device-side sleep of ``sleep_cycles``, so its two events
    bracket the device work alone and not the host's enqueue time.  A call
    whose enqueue outlasted the sleep is not counted (its events would
    hold a host gap); at least 90 % of the calls must count."""
    for b in batches[:2]:
        fn(b)
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    torch.cuda._sleep(sleep_cycles)
    e.record()
    e.synchronize()
    sleep_ms = s.elapsed_time(e)
    timed = []
    for i in range(iters):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()     # an empty launch queue never blocks
        torch.cuda._sleep(sleep_cycles)
        t0 = time.perf_counter()
        s.record()
        fn(batches[i % len(batches)])
        e.record()
        timed.append((s, e, (time.perf_counter() - t0) * 1e3 < sleep_ms))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e, ok in timed if ok]
    _check(len(ms) >= 0.9 * iters, f"the host enqueued {len(ms)} of {iters} "
           f"calls within the device sleep ({sleep_ms:.3f} ms)")
    return sum(ms) / len(ms)


def _records(torch, ycsb):
    """The YCSB load set on the card: (keys, values) as int32 words."""
    ids = np.arange(N_RECORDS, dtype=np.int64)
    keys = torch.from_numpy(ycsb.make_key(ids).view(np.int32)).cuda()
    vals = torch.from_numpy(ycsb.make_value(np.random.RandomState(SEED),
                                            N_RECORDS).view(np.int32)).cuda()
    return keys, vals


def _load(store, table, keys, vals):
    """Insert the records in batches of LOAD_BATCH; returns the results."""
    return [store.insert(table, keys[s:s + LOAD_BATCH],
                         vals[s:s + LOAD_BATCH])[1]
            for s in range(0, N_RECORDS, LOAD_BATCH)]


def _last_per_key(ids: np.ndarray) -> np.ndarray:
    """Index of the last occurrence of each distinct id (batch order)."""
    _, first_rev = np.unique(ids[::-1], return_index=True)
    return len(ids) - 1 - first_rev


def _ycsb_ids(keys_np: np.ndarray) -> np.ndarray:
    """Record ids back from YCSB keys (lanes 0/1 hold the id's halves)."""
    k = keys_np.astype(np.int64)
    return k[:, 0] | (k[:, 1] << 32)


def _residual_trips(torch, ch, cfg, keys_np) -> int:
    """Trips of an update batch's residual wave loop: the largest cohort
    of a pair that holds a duplicated key (all keys present)."""
    pair = ch.locate(cfg, torch.from_numpy(keys_np.view(np.int32)))[0].numpy()
    _, inv, cnt = np.unique(_ycsb_ids(keys_np), return_inverse=True,
                            return_counts=True)
    hot = np.unique(pair[cnt[inv] > 1])
    if not len(hot):
        return 0
    return int(np.bincount(np.searchsorted(hot, pair[np.isin(pair, hot)]))
               .max())


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _synthetic_cases(torch):
    """Rows of other widths and fills: all-empty, all-full (20 main bits),
    random words with bit 31 set, S = 32 and 30."""
    for S, fill in ((20, 0), (20, 0xFFFFF), (32, None), (30, None)):
        P, B = 4096, 4099
        rng = np.random.RandomState(S * 7 + (fill or 1))
        rows = rng.randint(0, 2 ** 32, size=(P, 4 * S), dtype=np.uint64)
        ind = (np.full((P, 1), fill, np.uint64) if fill is not None else
               rng.randint(0, 2 ** 32, size=(P, 1), dtype=np.uint64)
               | np.uint64(1 << 31))
        seg = (S * 4) // 5
        prio = np.full((2, S), 0x7FFFFFFF, np.int32)
        prio[0, :seg] = np.arange(seg)
        prio[1, list(range(S - 1, S - 1 - seg, -1))] = np.arange(seg)
        pairs = rng.randint(0, P, size=B)
        q = rng.randint(0, 2 ** 32, size=(B, 4), dtype=np.uint64)
        plant = rng.randint(0, S, size=B)
        q[::2] = rows[pairs[::2]].reshape(-1, S, 4)[
            np.arange(len(plant[::2])), plant[::2]]
        fps = rng.randint(0, 2 ** 32, size=(P, 2), dtype=np.uint64)

        def w(a):
            return torch.from_numpy(a.astype(np.uint32).view(np.int32)).cuda()

        def i32(a):
            return torch.from_numpy(a.astype(np.int32)).cuda()
        yield (f"synthetic S={S}, indicator "
               f"{'random|bit31' if fill is None else hex(fill)}",
               (w(rows), w(ind), i32(prio), i32(pairs),
                i32(rng.randint(0, 2, size=B)), w(q), w(fps),
                i32(rng.randint(0, 4, size=B))))


def kernel_phase(torch, api, ch, ycsb, K, probe, mutate, keys, vals,
                 card) -> list:
    """Phase 2 on its own full-size table; returns the kernels' rows."""
    from repro_torch.kernels.mutate_ref import mutate_ref
    from repro_torch.kernels.probe_ref import probe_ref
    store = api.make_store("continuity", num_buckets=NUM_BUCKETS,
                           stash_frac=0.0, device="cuda")
    cfg, S = store.cfg, store.cfg.slots_per_pair
    table = store.create()
    _, t_load = _timed(torch, lambda: _load(store, table, keys, vals))
    print(f"phase 2: full-size table loaded ({int(table.count)} items, "
          f"{t_load:.3f} s)", flush=True)
    rng = np.random.RandomState(SEED + 2)
    prio = torch.as_tensor(K.priority_table(cfg)).cuda()

    def operands():
        half = QUERY_B // 2
        q = np.concatenate([ycsb.make_key(rng.choice(N_RECORDS, half)),
                            ycsb.negative_keys(rng, N_RECORDS, half)])
        q = torch.from_numpy(q.view(np.int32)).cuda()
        pair, parity = ch.locate(cfg, q)
        return (K.table_rows(table), table.indicator[:, None], prio,
                pair.to(torch.int32), parity.to(torch.int32), q, table.fp,
                ch.fingerprint(q).to(torch.int32))

    runs = {
        "probe": (lambda o: probe.probe_segments(*o[:6]),
                  lambda o: probe_ref(*o[:6])),
        "probe_fp": (lambda o: probe.probe_segments(*o),
                     lambda o: probe_ref(*o)),
        "mutate": (lambda o: mutate.mutate_segments(*o[:2], o[6], *o[2:6],
                                                    o[7]),
                   lambda o: mutate_ref(*o[:2], o[6], *o[2:6], o[7])),
    }
    err = dict.fromkeys(runs, 0)

    def compare(case, o):
        for name, (kern, plain) in runs.items():
            for g, w in zip(kern(o), plain(o)):
                torch.cuda.synchronize()
                d = (g.to(torch.int64) - w.to(torch.int64)).abs()
                err[name] = max(err[name], int(d.max()) if d.numel() else 0)
                _check(torch.equal(g, w),
                       f"{name} kernel equals its plain version ({case})")

    full = operands()
    compare(f"full-size table, B={QUERY_B}", full)
    compare(f"full-size table, B={ODD_B}",
            full[:3] + tuple(x[:ODD_B] for x in full[3:6]) + full[6:7]
            + (full[7][:ODD_B],))
    for case, o in _synthetic_cases(torch):
        compare(case, o)
    print(f"phase 2: probe (fp off and on) and mutate equal their plain "
          f"versions on the full-size table (B={QUERY_B} and {ODD_B}) and "
          f"on synthetic empty/full/bit-31 rows; max_abs_err {err}",
          flush=True)

    # times at the main path's batch, beside the bound by bytes: per query
    # one row of S 16-byte keys (counted once per distinct pair), the
    # pair's indicator and fp words, its key, pair, parity, fingerprint,
    # and the outputs
    batches = [operands() for _ in range(8)]
    uniq = float(np.mean([int(torch.unique(o[3]).numel()) for o in batches]))
    rows = []
    specs = [("probe_segments", "src/repro/kernels/probe.py:130",
              runs["probe_fp"], max(err["probe"], err["probe_fp"]), 8),
             ("mutate_segments", "src/repro/kernels/mutate.py:93",
              runs["mutate"], err["mutate"], 12)]
    for name, replaces, (kern, plain), e, out_bytes in specs:
        ms = _device_ms(torch, kern, batches, 200, KERNEL_SLEEP)
        plain_ms = _device_ms(torch, plain, batches, 20, PLAIN_SLEEP)
        call_ms = _event_ms(torch, kern, batches, 200)
        nbytes = uniq * (S * 16 + 4 + 8) + QUERY_B * (16 + 4 + 4 + 4
                                                      + out_bytes)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_probe.cu",
            "replaces": replaces, "max_abs_err": e, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None})
        print(f"{name}: {ms * 1e3:.2f} us on the device per launch at "
              f"B={QUERY_B} (bound {bound_ms * 1e3:.2f} us from "
              f"{nbytes / 1e6:.2f} MB; plain version {plain_ms * 1e3:.2f} "
              f"us); {call_ms * 1e3:.2f} us per call back to back from "
              f"Python [{card}]", flush=True)
    ms_nofp = _device_ms(torch, runs["probe"][0], batches, 200,
                         KERNEL_SLEEP)
    print(f"probe_segments without the fp filter: {ms_nofp * 1e3:.2f} us on "
          f"the device per launch at B={QUERY_B} [{card}]", flush=True)
    del table, batches, full
    torch.cuda.empty_cache()
    _small_input_check(torch, api, ycsb)
    return rows


def _small_input_check(torch, api, ycsb) -> None:
    """The card's store (kernel policy) against the CPU store (plain
    versions, which the CPU tests hold against the JAX package) on a
    small input that reaches the extension pool and the stash tier."""
    rng = np.random.RandomState(SEED + 3)
    ids = np.concatenate([np.arange(2400), rng.randint(0, 2400, 64)])
    keys, vals = ycsb.make_key(ids), ycsb.make_value(rng, len(ids))
    vals2 = ycsb.make_value(rng, len(ids))
    q = np.concatenate([keys, ycsb.negative_keys(rng, 2400, 256)])
    out = []
    for dev in ("cpu", "cuda"):
        st = api.make_store("continuity", table_slots=2048, device=dev)
        t = st.create()
        t, r1 = st.insert(t, keys, vals)
        t, r2 = st.update(t, keys[::2], vals2[::2])
        t, r3 = st.delete(t, keys[1::3])
        r4 = st.lookup(t, q)
        out.append([*t, r1.ok, r2.ok, r3.ok, r4.ok, r4.values, r4.reads,
                    *r4.plan])
    _check(int((out[0][12] != 0).sum()) > 0, "small input reaches the stash")
    _check(all(torch.equal(a, b.cpu()) for a, b in zip(*out)),
           "card and CPU stores give byte-equal tables and results")
    print("phase 2: small input (extension pool and stash tier): the card's "
          "store equals the CPU store, tables byte for byte", flush=True)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def main_path(torch, api, ch, ycsb, K, keys, vals, card) -> dict:
    """The port's request path at full size; returns its numbers."""
    store = api.make_store("continuity", num_buckets=NUM_BUCKETS,
                           stash_frac=0.0, device="cuda")
    cfg = store.cfg
    rng = np.random.RandomState(SEED + 4)
    out = {}

    # -- bulk load: 48 insert batches of 2**20 ---------------------------
    table = store.create()
    results, t_ins = _timed(torch, lambda: _load(store, table, keys, vals))
    ok = torch.cat([r.ok for r in results])
    n_ok = int(ok.sum())
    pm = sum(int(r.ledger.pm_writes) for r in results)
    _check(sum(int(r.ledger.ops) for r in results) == N_RECORDS,
           "insert ledger counts every op")
    _check(pm == 2 * n_ok, "Table I: 2 PM writes per committed insert")
    _check(int(table.count) == n_ok, "table count equals acknowledged inserts")
    lf = float(store.load_factor(table))
    out.update(insert_ops_s=N_RECORDS / t_ins)
    print(f"load: {n_ok} of {N_RECORDS} inserts acknowledged in "
          f"{len(results)} batches of {LOAD_BATCH}, {t_ins:.3f} s = "
          f"{N_RECORDS / t_ins:.0f} inserts/s, PM writes per committed "
          f"insert {pm / n_ok}, load factor {lf:.6f}, extension groups "
          f"{int(table.ext_count)}, device memory in use "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB [{card}]",
          flush=True)

    # -- read back every acknowledged key --------------------------------
    def readback():
        hit_all, reads = True, 0
        for s in range(0, N_RECORDS, READ_BATCH):
            res = store.lookup(table, keys[s:s + READ_BATCH])
            o = ok[s:s + READ_BATCH]
            hit_all &= bool(torch.equal(res.ok, o))
            hit_all &= bool(torch.equal(res.values[o],
                                        vals[s:s + READ_BATCH][o]))
            reads += int(res.ledger.rdma_reads)
        return hit_all, reads
    (hit_all, reads), t_read = _timed(torch, readback)
    _check(hit_all, "every acknowledged insert reads back its value, and "
           "no unacknowledged key is found")
    _check(reads >= N_RECORDS, "reads_per_op >= 1")
    out.update(lookup_ops_s=N_RECORDS / t_read)
    print(f"read-back: {N_RECORDS} lookups in batches of {READ_BATCH}, every "
          f"acknowledged key found with its value, {t_read:.3f} s = "
          f"{N_RECORDS / t_read:.0f} lookups/s, reads per op "
          f"{reads / N_RECORDS:.6f} [{card}]", flush=True)

    neg = ycsb.negative_keys(rng, N_RECORDS, READ_BATCH)
    _check(not bool(store.lookup(table, neg).ok.any()),
           "negative lookups all miss")
    print(f"negatives: {READ_BATCH} absent keys, none found", flush=True)

    # -- YCSB-A: zipf 0.99, 50 % reads / 50 % updates --------------------
    cur = vals.clone()        # the value each key should hold now
    t_rd = t_up = 0.0
    n_rd = n_up = n_fail = 0
    for batch in ycsb.generate("A", N_RECORDS, YCSB_BATCHES * QUERY_B,
                               QUERY_B, seed=SEED + 1):
        bids = _ycsb_ids(batch.keys)
        rsel = batch.ops == ycsb.OP_READ
        usel = batch.ops == ycsb.OP_UPDATE
        rk = torch.from_numpy(batch.keys[rsel].view(np.int32)).cuda()
        ri = torch.from_numpy(bids[rsel]).cuda()
        res, t = _timed(torch, lambda: store.lookup(table, rk))
        t_rd += t
        n_rd += int(rsel.sum())
        _check(torch.equal(res.ok, ok[ri]), "YCSB-A reads find every "
               "acknowledged key and nothing else")
        _check(torch.equal(res.values[res.ok], cur[ri][res.ok]),
               "YCSB-A reads return the current values")
        uk, uv, ui = batch.keys[usel], batch.vals[usel], bids[usel]
        trips = _residual_trips(torch, ch, cfg, uk)
        (_, ures), t = _timed(torch, lambda: store.update(table, uk, uv))
        t_up += t
        n_up += len(ui)
        uok = ures.ok.cpu().numpy()
        uidx = torch.from_numpy(ui).cuda()
        _check(not (uok & ~ok[uidx].cpu().numpy()).any(),
               "no update of an unacknowledged key succeeds")
        n_fail += int((~uok).sum())
        okidx = np.nonzero(uok)[0]
        if len(okidx):    # the last acknowledged update of a key wins
            li = okidx[_last_per_key(ui[okidx])]
            cur[torch.from_numpy(ui[li]).cuda()] = torch.from_numpy(
                uv[li].view(np.int32)).cuda()
        chk = store.lookup(table, uk)
        _check(torch.equal(chk.ok, ok[uidx]) and torch.equal(
            chk.values[chk.ok], cur[uidx][chk.ok]), "updated values read back")
        print(f"YCSB-A batch: {int(rsel.sum())} reads, {len(ui)} updates "
              f"({len(np.unique(ui))} distinct keys, {int((~uok).sum())} "
              f"refused), residual wave trips {trips}, update "
              f"{t * 1e3:.3f} ms", flush=True)
    out.update(ycsb_read_ops_s=n_rd / t_rd, ycsb_update_ops_s=n_up / t_up)
    print(f"YCSB-A: {n_rd} reads in {t_rd:.3f} s = {n_rd / t_rd:.0f} "
          f"lookups/s, {n_up} updates ({n_fail} refused) in {t_up:.3f} s = "
          f"{n_up / t_up:.0f} updates/s (batches of {QUERY_B}) [{card}]",
          flush=True)

    # -- duplicate-free update and delete batches: Table I 2 / 1 ---------
    pick = rng.choice(N_RECORDS, 2 * QUERY_B, replace=False)
    _check(bool(ok[torch.from_numpy(pick).cuda()].all()),
           "picked keys were acknowledged")
    pk = ycsb.make_key(pick)
    nv = ycsb.make_value(rng, QUERY_B)
    before = store.lookup(table, pk[:QUERY_B]).values
    (_, ures), t_u = _timed(torch, lambda: store.update(table, pk[:QUERY_B],
                                                        nv))
    # an out-of-place update needs a free slot in the key's segment (or its
    # extension group); where there is none it is refused and writes nothing
    u_ok = ures.ok
    n_uok = int(u_ok.sum())
    _check(n_uok > 0.9 * QUERY_B, "distinct-key updates of live keys "
           "mostly succeed")
    _check(int(ures.ledger.pm_writes) == 2 * n_uok,
           "Table I: 2 PM writes per committed update")
    chk = store.lookup(table, pk[:QUERY_B])
    want = torch.where(u_ok[:, None],
                       torch.from_numpy(nv.view(np.int32)).cuda(), before)
    _check(bool(chk.ok.all()) and torch.equal(chk.values, want),
           "committed updates read back, refused ones keep the old value")
    count0 = int(table.count)
    (_, dres), t_d = _timed(torch, lambda: store.delete(table, pk[QUERY_B:]))
    _check(bool(dres.ok.all()), "deletes of live keys succeed")
    _check(int(table.count) == count0 - QUERY_B, "count drops by the deletes")
    _check(not bool(store.lookup(table, pk[QUERY_B:]).ok.any()),
           "deleted keys are gone")
    table1 = (pm / n_ok, int(ures.ledger.pm_writes) / n_uok,
              dres.ledger.pm_per_op())
    _check(table1 == (2.0, 2.0, 1.0),
           "Table I: 2 / 2 / 1 PM writes per committed op")
    out.update(update_ops_s=QUERY_B / t_u, delete_ops_s=QUERY_B / t_d)
    print(f"Table I (PM writes per committed insert/update/delete): "
          f"{table1}; distinct-key batches of {QUERY_B}: update "
          f"{t_u * 1e3:.3f} ms = {QUERY_B / t_u:.0f} updates/s "
          f"({QUERY_B - n_uok} refused: no free slot in the segment), "
          f"delete {t_d * 1e3:.3f} ms = {QUERY_B / t_d:.0f} deletes/s "
          f"[{card}]", flush=True)

    # -- the kernel policy agrees with the gather policy ----------------
    sample = np.concatenate([ycsb.make_key(rng.choice(N_RECORDS, QUERY_B // 2)),
                             ycsb.negative_keys(rng, N_RECORDS, QUERY_B // 2)])
    gstore = store.with_policy(api.ExecPolicy(probe="gather"))
    a, b = store.lookup(table, sample), gstore.lookup(table, sample)
    _check(torch.equal(a.ok, b.ok) and torch.equal(a.values, b.values)
           and torch.equal(a.reads, b.reads)
           and all(torch.equal(x, y) for x, y in zip(a.plan, b.plan)),
           "kernel and gather policies give the same lookups and plans")
    ra, rb = K.probe_lookup(cfg, table, sample), ch.lookup(cfg, table, sample)
    _check(all(torch.equal(x, y) for x, y in zip(ra, rb)),
           "probe_lookup equals continuity.lookup (found/values/slot/reads)")
    print(f"kernel vs gather policy: {QUERY_B} lookups identical "
          f"({int(a.ok.sum())} found)", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import api
    from repro_torch.core import continuity as ch
    from repro_torch.data import ycsb
    from repro_torch.kernels import _cuda, mutate, probe
    from repro_torch.kernels import ops as K

    # -- phase 1: header and build ---------------------------------------
    card = _smi()
    t0 = time.perf_counter()
    _cuda.segment_probe_lib()
    t_build = time.perf_counter() - t0
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; kernel build {t_build:.2f} s", flush=True)
    for line in _cuda.build_log.get("segment_probe.cu", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    keys, vals = _records(torch, ycsb)

    # -- phase 2: kernels against their plain versions -------------------
    rows = kernel_phase(torch, api, ch, ycsb, K, probe, mutate, keys, vals,
                        card)

    # -- phase 3: the main path, its launches counted --------------------
    torch.cuda.reset_peak_memory_stats()
    probe.probe_segments.launches = 0
    mutate.mutate_segments.launches = 0
    t0 = time.perf_counter()
    main_path(torch, api, ch, ycsb, K, keys, vals, card)
    t_main = time.perf_counter() - t0
    launches = {"probe_segments": probe.probe_segments.launches,
                "mutate_segments": mutate.mutate_segments.launches}
    print(f"main path: {t_main:.1f} s, kernel launches {launches}, device "
          f"memory in use {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
          f"[{card}]", flush=True)
    for name, n in launches.items():
        _check(n > 0, f"the main path launched {name}")

    # -- phase 4: report -------------------------------------------------
    for r in rows:
        r["launches"] = launches[r["name"]]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in order} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
