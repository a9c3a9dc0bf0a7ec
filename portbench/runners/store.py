"""Runner of a store configuration: the port's hash store under a YCSB mix.

Set-up: the store is built with ``repro_torch.api.make_store`` at the
configuration's geometry and loaded with ``record_count`` records (keys
from the ids, values drawn from the seed) in batches of ``load_batch``;
then ``warmup_batches`` batches of the mix run untimed.  The window runs
batches back to back, one in flight: each batch's keys are drawn on the
device and synchronized before its timed interval opens, then its reads
go through ``ContinuityStore.lookup`` and its updates through
``ContinuityStore.update``, each call ending in a device synchronize.
The window is the sum of the batches' timed intervals (the draws and the
log of answers fall between them), and closes after the first batch that
brings it past ``seconds``.

Checked after the window against ``refs/kvmap.py``: every record of the
load acknowledged (``load_refused``); the found flag and value of
``check_rows`` reads of every batch (rows drawn from the seed); every
acknowledged update applied in batch order, refused ones leaving the
value; the share of the window's updates refused (``refused_share``,
limit in the configuration); a read-back of the last batch's updated
keys and of ``check_rows`` further records through the store; and Table
I over the load and the window's updates.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import counters as C
from portbench import harness as H
from portbench import plants, traffic, ycsb
from portbench.refs.kvmap import KVMap


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_store(config: dict, device):
    from repro_torch import api
    geometry = {k: config[k] for k in ("num_buckets", "bucket_slots",
                                       "sbuckets", "ext_frac", "stash_frac")}
    return api.make_store(config["scheme"], device=str(device), **geometry)


def record_values(config: dict, seed: int, device) -> torch.Tensor:
    """The load set's values, drawn from the seed (its keys are made from
    the ids 0 .. record_count - 1)."""
    return ycsb.make_value(traffic.generator(seed, "records", device),
                           int(config["record_count"]))


class Log:
    """What the window's batches produced that the reference judges."""

    def __init__(self, check_rows: int, n_read: int, seed: int, device):
        g = traffic.generator(seed, "check", device)
        k = min(check_rows, n_read)
        self.rows = torch.randperm(n_read, generator=g,
                                   device=device)[:k].sort().values
        self.reads = []       # (found, values) at the checked rows
        self.updates = []     # each update's acknowledgement

    def batch(self, res, ures) -> None:
        if res is not None:
            self.reads.append((res.ok[self.rows], res.values[self.rows]))
        if ures is not None:
            self.updates.append(ures.ok)


def run(cell: H.Cell, *, t_start: float) -> H.Outcome:
    with plants.planted("store", cell.plant):
        return _run(cell, t_start)


def _run(cell: H.Cell, t_start: float) -> H.Outcome:
    config, mix, dev, rec = cell.config, cell.traffic, cell.device, cell.rec
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    store = make_store(config, dev)
    table = store.create()
    keys = ycsb.make_key(torch.arange(int(config["record_count"]),
                                      device=dev))
    values = record_values(config, cell.seed, dev)
    step = int(config["load_batch"])
    load = [store.insert(table, keys[s:s + step], values[s:s + step])[1]
            for s in range(0, len(keys), step)]
    live = torch.cat([r.ok for r in load])
    load_pm = int(sum(r.ledger.pm_writes for r in load))
    del keys, values, load
    stash0 = int((table.stash_meta != 0).sum())

    gen = traffic.StoreTraffic(mix, config, cell.seed, dev)
    log = Log(int(mix["check_rows"]), gen.n_read, cell.seed, dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    acc = {k: zero.clone() for k in ("reads", "lookups", "pm", "acked")}

    def one_batch(b: dict, timed: bool) -> float:
        """Serve one drawn batch; returns its timed interval."""
        t0 = time.perf_counter()
        res = ures = None
        if gen.n_read:
            with H.label("lookup"):
                res = store.lookup(table, b["read_keys"])
                sync(dev)
        t1 = time.perf_counter()
        if gen.n_update:
            with H.label("update"):
                _, ures = store.update(table, b["update_keys"],
                                       b["update_vals"])
                sync(dev)
        t2 = time.perf_counter()
        log.batch(res, ures)
        if timed:
            if res is not None:
                rec.span("lookup", t1 - t0)
                acc["reads"] += res.ledger.rdma_reads
                acc["lookups"] += res.ledger.ops
            if ures is not None:
                rec.span("update", t2 - t1)
                acc["pm"] += ures.ledger.pm_writes
                acc["acked"] += ures.ok.sum()
            rec.span("batch", t2 - t0)
        return t2 - t0

    def drawn() -> dict:
        b = gen.next()
        sync(dev)
        return b

    for _ in range(int(mix["warmup_batches"])):
        one_batch(drawn(), False)
    sync(dev)
    setup_s = time.perf_counter() - t_start
    n_batches, window_s = 0, 0.0
    while window_s < cell.seconds:
        last = drawn()
        window_s += one_batch(last, True)
        n_batches += 1

    trace = None
    if cell.trace:
        trace = profile_batches(cell, gen, one_batch)

    # the last batch's updated keys and further records, read back
    # through the store once the window has closed
    back = None
    if gen.n_update:
        extra = ycsb.make_key(torch.randint(
            0, gen.records, (log.rows.numel(),), device=dev,
            generator=traffic.generator(cell.seed, "check", dev)))
        back_keys = torch.cat([last["update_keys"], extra])
        r = store.lookup(table, back_keys)
        back = (back_keys, r.ok, r.values)
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del table, store
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    counts = {k: int(v) for k, v in acc.items()}
    n_reads = n_batches * gen.n_read
    n_updates = n_batches * gen.n_update
    refused = n_updates - counts["acked"]
    done = n_reads + counts["acked"]
    times = np.asarray(rec.spans["batch"])
    e2e = {"ops_s": done / window_s,
           "batch_p95_ms": float(np.percentile(times, 95)) * 1e3,
           "setup_s": setup_s}
    if not gen.n_update:
        e2e["read_ops_s"] = e2e["ops_s"]
    rec.count("rdma_reads", counts["reads"])
    rec.count("lookup_ops", counts["lookups"])

    load_acked = int(live.sum())
    checks = [H.Check("load_refused", int(config["record_count"])
                      - load_acked, 0)]
    checks += judge(cell, config, gen, log, live, back)
    # Table I: the load wrote 2 PM writes per acknowledged insert and 3 per
    # insert into the stash; the window's updates 2 each, 3 for at most
    # one update per stash entry
    off = abs(load_pm - 2 * load_acked - stash0)
    if gen.n_update:
        pm, acked = counts["pm"], counts["acked"]
        off += max(0, 2 * acked - pm) + max(0, pm - 2 * acked - stash0)
        checks.append(H.Check("refused_share", refused / n_updates,
                              config["limits"]["refused_share"]))
    checks.append(H.Check("pm_writes_off", off, 0))
    facts = {"batches": n_batches, "units": n_batches, "window_s": window_s,
             "load_acked": load_acked, "load_pm_writes": load_pm,
             "stash_entries": stash0, "refused_updates": refused}
    return H.Outcome(e2e=e2e, attempted=n_reads + n_updates, failed=refused,
                     memory_peak_bytes=peak, checks=checks, trace=trace,
                     facts=facts)


def profile_batches(cell, gen, one_batch) -> H.Trace:
    """``profile_batches`` more batches of the mix, drawn first, served
    under the profiler, with the bytes their segment-probe launches need
    (launches counted by the port's own counters)."""
    from repro_torch.kernels import mutate, probe
    n = int(cell.traffic["profile_batches"])
    S = cell.config["bucket_slots"] * (2 + cell.config["sbuckets"])
    drawn = [gen.next() for _ in range(n)]
    sync(cell.device)
    before = probe.probe_segments.launches, mutate.mutate_segments.launches

    def slice_():
        for b in drawn:
            one_batch(b, False)
    trace = H.profile_slice(slice_)
    nbytes = 0
    for b in drawn:
        for keys, out in ((b.get("read_keys"), 8), (b.get("update_keys"), 12)):
            if keys is not None:
                rows = torch.unique(C.home_pairs(
                    keys, cell.config["num_buckets"])).numel()
                nbytes += C.probe_bytes(len(keys), rows, S, out)
    rec = cell.rec
    rec.count("probe_bytes_profiled", nbytes)
    rec.count("probe_launches_profiled",
              probe.probe_segments.launches - before[0]
              + mutate.mutate_segments.launches - before[1])
    rec.count("store_calls_profiled",
              n * ((gen.n_read > 0) + (gen.n_update > 0)))
    rec.count("profiled_units", n)
    return trace


def judge(cell, config, gen, log, live, back) -> list:
    """The window's answers against the reference map, replayed from the
    seed in batch order."""
    dev = cell.device
    ref = KVMap(gen.records, record_values(config, cell.seed, dev), live)
    gen.restart()
    wrong = bad_acks = 0
    for i in range(max(len(log.reads), len(log.updates))):
        b = gen.next()
        if gen.n_read:
            found, vals = log.reads[i]
            want_found, want_vals = ref.lookup(b["read_keys"][log.rows])
            wrong += int(((found != want_found)
                          | (vals != want_vals).any(-1)).sum())
        if gen.n_update:
            bad_acks += ref.update(b["update_keys"], b["update_vals"],
                                   log.updates[i])
    checks = [H.Check("wrong_reads", wrong, 0)]
    if gen.n_update:
        keys, found, vals = back
        want_found, want_vals = ref.lookup(keys)
        stale = int(((found != want_found)
                     | (vals != want_vals).any(-1)).sum())
        checks.append(H.Check("wrong_updates", bad_acks + stale, 0))
    return checks
