"""End-to-end YCSB client/server simulation over the RDMA transport.

Port of ``repro.rdma.sim``.  A client runs a YCSB mix against a remote PM
server and the scheme decides what every op puts on the wire: the scheme
executes exactly (on ``device``, CUDA unless the caller asks for the CPU),
its `OpResult.plan` is posted through one `RemoteMemory` endpoint with
doorbell batching, and the analytical `LinkModel` prices the batch.  The
throughput and p50/p99 latency it returns are `LinkModel` outputs, not
device measurements; their RELATIVE ordering across schemes is the
reproducible claim (continuity > level > pfarm on read-heavy mixes).

Reads are priced from the scheme's exact verb plan.  Writes are priced from
a plan synthesized from the scheme's own `CostLedger`: one ordered remote
WRITE (+ remote-persist fence) per PM write the op charges, payload stores
as slot-sized WRITEs, the 8-byte commit word last.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.continuity import SLOT_BYTES
from repro_torch.data import ycsb
from repro_torch.rdma import verbs as rv
from repro_torch.rdma.transport import LinkModel, RemoteMemory

COMMIT_BYTES = 8        # the 8-byte atomic indicator/token commit word

# YCSB mixes the simulation drives (paper §V-A): A/B/C the paper's trio,
# D read-latest, E short scans, F read-modify-write on the SAME key
SIM_WORKLOADS = ("A", "B", "C", "D", "E", "F")


def write_plan(B: int, pm_per_op: int, extra_ops: int = 0,
               payload_bytes: int = SLOT_BYTES) -> rv.VerbPlan:
    """The remote-write verb plan of B ops: each op issues its PM-write
    count as ordered slot-sized WRITEs ending in the 8-byte commit WRITE,
    every store followed by a remote-persist fence (a dependent round).
    The last ``extra_ops`` rows charge ``pm_per_op + 1`` writes, the rest
    ``pm_per_op``, so a batch keeps its EXACT PM-write total."""
    pm = max(1, int(pm_per_op))
    extra_ops = min(max(0, int(extra_ops)), B)
    counts = torch.where(torch.arange(B) >= B - extra_ops, pm + 1, pm)
    lanes = []
    for d in range(pm + (1 if extra_ops else 0)):
        lanes.append((torch.where(d < counts, rv.WRITE, rv.NOOP),
                      rv.REGION_TABLE, 0,
                      torch.where(d == counts - 1, COMMIT_BYTES,
                                  payload_bytes), d, True))
    return rv.pack(B, lanes)


def post_ledger_writes(mem: RemoteMemory, n_ok: int, total_pm: int):
    """Post the exact-total fenced write plan a batch's `CostLedger`
    implies: ``floor(total_pm / n_ok)`` writes per op, the remainder ops
    one more.  Returns the `Completion`, or None for an empty or
    write-free batch."""
    if not (n_ok and total_pm):
        return None
    lo = max(1, total_pm // n_ok)
    return mem.post(write_plan(n_ok, lo, extra_ops=total_pm - lo * n_ok))


def _mix_counts(workload: str, batch: int):
    """(reads, updates, inserts, scans, rmw) per batch.  An RMW op counts
    toward BOTH reads and updates; ``rmw`` is the overlap, so the logical
    ops are ``reads + updates + inserts + scans - rmw``."""
    mix = dict(ycsb.WORKLOADS[workload])
    n_rmw = int(batch * mix.get(ycsb.OP_RMW, 0))
    n_read = int(batch * mix.get(ycsb.OP_READ, 0)) + n_rmw
    n_upd = int(batch * mix.get(ycsb.OP_UPDATE, 0)) + n_rmw
    n_ins = int(batch * mix.get(ycsb.OP_INSERT, 0))
    n_scan = int(batch * mix.get(ycsb.OP_SCAN, 0))
    return n_read, n_upd, n_ins, n_scan, n_rmw


def run_ycsb(scheme: str, workload: str, *, num_records: int = 3000,
             num_ops: int = 4000, batch: int = 500,
             load_factor: float = 0.7, link: Optional[LinkModel] = None,
             seed: int = 0, device: str = "cuda") -> Dict[str, float]:
    """One scheme x workload cell: load ``num_records`` into a store on
    ``device``, run ``num_ops`` of the mix in doorbell-batched rounds,
    return the simulated throughput and latency percentiles.
    Deterministic given the seed (the transport model has no noise), and
    the same on every device: random draws come from
    ``np.random.RandomState(seed)`` in the reference's order."""
    from repro_torch import api
    if workload not in SIM_WORKLOADS:
        raise ValueError(f"workload must be one of {SIM_WORKLOADS}: "
                         f"{workload!r}")
    n_read, n_upd, n_ins, n_scan, n_rmw = _mix_counts(workload, batch)
    n_logical = n_read + n_upd + n_ins + n_scan - n_rmw
    rounds = -(-num_ops // max(1, n_logical))
    slots = int(np.ceil((num_records + n_ins * rounds) / load_factor))
    store = api.make_store(scheme, table_slots=slots,
                           policy=api.ExecPolicy(transport="sim"),
                           device=device)
    mem = RemoteMemory.from_policy(store.policy, link)

    rng = np.random.RandomState(seed)
    K = ycsb.make_key(np.arange(num_records))
    V = ycsb.make_value(rng, num_records)
    table, res = store.insert(store.create(), K, V)
    loaded = np.flatnonzero(res.ok.cpu().numpy())   # read resident keys only
    zipf = ycsb.Zipf(len(loaded))
    # YCSB scrambles zipfian ranks over the keyspace: popularity is
    # independent of insertion order
    scramble = rng.permutation(len(loaded))
    order_ids = list(loaded)      # insertion order (D's read-latest axis)
    next_id = num_records

    h_read, h_write = obs.Histogram(), obs.Histogram()
    ops_done = 0
    while ops_done < num_ops:
        if workload == "D":
            # read-latest: the zipf ranks index the insertion order from
            # the newest end (no scramble)
            zipf_d = ycsb.Zipf(len(order_ids))
            ids = np.asarray(order_ids)[len(order_ids) - 1
                                        - zipf_d.sample(rng, n_read)]
        elif n_read:
            ids = loaded[scramble[zipf.sample(rng, n_read)]]
        if n_read:
            hits = store.lookup(table, ycsb.make_key(ids))
            comp = mem.post(hits.plan, tag="read")
            h_read.record_many(comp.op_us)
        if n_scan:
            # YCSB-E short scans: the wire cost IS the scan plan; the
            # lookup runs for start-key correctness only
            starts = loaded[scramble[zipf.sample(rng, n_scan)]]
            spans = ycsb.scan_lengths(rng, n_scan)
            skeys = ycsb.make_key(starts)
            store.lookup(table, skeys)
            comp = mem.post(store.scan_plan(table, skeys, spans),
                            tag="scan")
            h_read.record_many(comp.op_us)
        if n_ins:
            ins_ids = np.arange(next_id, next_id + n_ins)
            next_id += n_ins
            table, ires = store.insert(table, ycsb.make_key(ins_ids),
                                       ycsb.make_value(rng, n_ins))
            iok = ires.ok.cpu().numpy()
            order_ids.extend(int(i) for i in ins_ids[iok])
            comp = post_ledger_writes(mem, int(iok.sum()),
                                      int(ires.ledger.pm_writes))
            if comp is not None:
                h_write.record_many(comp.op_us)
        if n_upd:
            # F's updates are the write half of read-modify-write: the keys
            # the SAME round just read
            ids = (ids[-n_upd:] if n_rmw
                   else loaded[scramble[zipf.sample(rng, n_upd)]])
            table, ures = store.update(table, ycsb.make_key(ids),
                                       ycsb.make_value(rng, n_upd))
            comp = post_ledger_writes(mem, int(ures.ok.sum()),
                                      int(ures.ledger.pm_writes))
            if comp is not None:
                h_write.record_many(comp.op_us)
        ops_done += n_logical
    if table.count.is_cuda:
        torch.cuda.synchronize(table.count.device)

    # every percentile comes from the merged sketch
    merged = obs.Histogram()
    merged.merge(h_read)
    merged.merge(h_write)
    reg = obs.get_registry()
    reg.histogram("e2e.op_us", scheme=scheme, workload=workload,
                  op="read").merge(h_read)
    reg.histogram("e2e.op_us", scheme=scheme, workload=workload,
                  op="write").merge(h_write)
    out = {
        "ops_per_s": ops_done / mem.total_us * 1e6,
        "p50_us": merged.percentile(50),
        "p99_us": merged.percentile(99),
        "doorbells": float(mem.doorbells),
        "verbs_per_op": mem.total_verbs / ops_done,
        "bytes_per_op": mem.total_bytes / ops_done,
    }
    if h_read.count:
        out["read_p50_us"] = h_read.percentile(50)
    if h_write.count:
        out["write_p50_us"] = h_write.percentile(50)
    return out


def run_all(schemes=None, workloads=SIM_WORKLOADS, **kw) -> Dict[str, dict]:
    """{scheme: {workload: cell}} over the registered schemes."""
    from repro_torch import api
    out: Dict[str, dict] = {}
    for s in (schemes or api.available_schemes()):
        for wl in workloads:
            out.setdefault(s, {})[wl] = run_ycsb(s, wl, **kw)
    return out
