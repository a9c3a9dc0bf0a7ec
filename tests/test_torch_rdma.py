"""The port's transport, telemetry sketches and end-to-end YCSB simulator
against the JAX package's, on the CPU.

``RemoteMemory.post`` must give the same `Completion` and counters as the
reference's on the same plans (doorbell coalescing, dependent depths,
fences, seeded drop / duplicate / reorder faults with retries); the
histogram sketch the same percentiles; ``run_ycsb`` for continuity the
same dict on every mix (the baselines' cells are in
``tests/test_torch_sim_baselines.py``); and the simulated ordering of
``tests/test_rdma.py::test_end_to_end_ordering_read_heavy`` holds.
"""

import numpy as np
import pytest
import torch

from _simparity import SMALL, assert_cell_matches
from repro import api as japi
from repro import obs as jobs
from repro import rdma as jrdma
from repro.data import ycsb
from repro.rdma import sim as jsim
from repro.rdma import transport as jtr
from repro.rdma import verbs as jrv
from repro_torch import api, obs, rdma
from repro_torch.rdma import sim
from repro_torch.rdma import transport as tr
from repro_torch.rdma import verbs as rv


def lanes(rng, B):
    """Random verb lanes: reads and fenced writes at depths 0-2."""
    out = []
    for m in range(4):
        verb = rng.randint(0, 4, B)
        nbytes = rng.randint(8, 600, B)
        out.append((verb, m % 3, rng.randint(0, 1 << 20, B), nbytes,
                    rng.randint(0, 3, B), rng.rand(B) < 0.5))
    return out


def both_plans(rng, B):
    ls = lanes(rng, B)
    jp = jrv.pack(B, ls)
    tp = rv.pack(B, [tuple(torch.as_tensor(np.asarray(x)) for x in lane)
                     for lane in ls])
    return jp, tp


def assert_completion_equal(jc, tc):
    assert tc.batch_us == jc.batch_us
    np.testing.assert_array_equal(tc.op_us, jc.op_us)
    assert (tc.rounds, tc.verbs, tc.bytes) == (jc.rounds, jc.verbs, jc.bytes)


@pytest.mark.parametrize("faults", [None, dict(drop_p=0.2),
                                    dict(dup_p=0.3), dict(reorder_p=0.3),
                                    dict(drop_p=0.1, dup_p=0.1,
                                         reorder_p=0.1)])
def test_post_matches_reference(faults):
    """Same plans, same seed: same completions, counters and stats()."""
    rng = np.random.RandomState(0)
    jmem = jtr.RemoteMemory(
        faults=jtr.FaultInjector(seed=3, **faults) if faults else None)
    tmem = tr.RemoteMemory(
        faults=tr.FaultInjector(seed=3, **faults) if faults else None)
    for i, B in enumerate((1, 7, 64, 250, 33)):
        jp, tp = both_plans(rng, B)
        tag = ("read", "write", None)[i % 3]
        assert_completion_equal(jmem.post(jp, tag=tag), tmem.post(tp, tag=tag))
    assert tmem.stats() == jmem.stats()
    h = "rdma.op_us"
    assert (tmem.metrics.histogram(h).to_dict()
            == jmem.metrics.histogram(h).to_dict())


def test_doorbells_depths_and_fences():
    """One RTT for a batch of independent verbs, one more per depth, and
    the fenced write plan's per-op price, as the reference states them."""
    link = tr.LinkModel()
    mem = tr.RemoteMemory(link)
    comp = mem.post(rv.pack(64, [(rv.READ, rv.REGION_TABLE, 0, 520, 0,
                                  False)]))
    assert comp.rounds == 1 and comp.verbs == 64
    assert comp.batch_us == pytest.approx(link.rtt_us + 64 * (
        link.verb_us + 520 / link.nic_bytes_per_us
        + 520 / link.pm_read_bytes_per_us))
    c1 = mem.post(rv.pack(8, [(rv.READ, rv.REGION_TABLE, 0, 100, 0, False),
                              (rv.READ, rv.REGION_EXT, 0, 100, 1, False)]))
    assert c1.rounds == 2 and mem.doorbells == 3 and mem.posts == 2
    for B, pm, extra in ((4, 2, 0), (5, 2, 3), (3, 5, 0)):
        jc = jtr.RemoteMemory(link).post(jsim.write_plan(B, pm, extra))
        tc = tr.RemoteMemory(link).post(sim.write_plan(B, pm, extra))
        assert_completion_equal(jc, tc)
    per_op = 2 * link.rtt_us + 2 * (link.verb_us + link.fence_us) \
        + (32 + 8) / link.nic_bytes_per_us \
        + (32 + 8) / link.pm_write_bytes_per_us
    assert tr.RemoteMemory(link).post(sim.write_plan(4, 2)).op_us[0] == \
        pytest.approx(per_op)


def test_retry_budget_raises_delivery_timeout():
    for mod in (jtr, tr):
        mem = mod.RemoteMemory(faults=mod.FaultInjector(drop_p=1.0, seed=1),
                               retry=mod.RetryPolicy(max_attempts=3))
        plan = (jrv if mod is jtr else rv).pack(
            4, [(1, 0, 0, 64, 0, False)])
        with pytest.raises(mod.DeliveryTimeout):
            mem.post(plan, tag="read")
        assert (mem.timeouts, mem.retries, mem.give_ups, mem.posts) == \
            (3, 3, 1, 1)
    backoff = [tr.RetryPolicy().backoff_us(a, np.random.RandomState(0))
               for a in range(8)]
    assert backoff == [jtr.RetryPolicy().backoff_us(
        a, np.random.RandomState(0)) for a in range(8)]


def test_transport_selection_through_exec_policy():
    assert rdma.RemoteMemory.from_policy(api.ExecPolicy()) is None
    mem = rdma.RemoteMemory.from_policy(api.ExecPolicy(transport="sim"))
    assert isinstance(mem, rdma.RemoteMemory)
    with pytest.raises(ValueError):
        api.ExecPolicy(transport="infiniband")


@pytest.mark.parametrize("scheme", ["continuity", "level", "pfarm", "dense"])
def test_store_plans_price_the_same(scheme):
    """The port's lookup and scan plans, posted, cost what the reference's
    cost: the stores emit the same verbs."""
    rng = np.random.RandomState(1)
    K = ycsb.make_key(np.arange(600))
    V = ycsb.make_value(rng, 600)
    js = japi.make_store(scheme, table_slots=900)
    ts = api.make_store(scheme, table_slots=900, device="cpu")
    jt, _ = js.insert(js.create(), K, V)
    tt, _ = ts.insert(ts.create(), K, V)
    q = np.concatenate([K[:300], ycsb.negative_keys(rng, 600, 100)])
    spans = ycsb.scan_lengths(rng, len(q))
    jmem, tmem = jrdma.RemoteMemory(), rdma.RemoteMemory()
    assert_completion_equal(jmem.post(js.lookup(jt, q).plan),
                            tmem.post(ts.lookup(tt, q).plan))
    assert_completion_equal(jmem.post(js.scan_plan(jt, q, spans)),
                            tmem.post(ts.scan_plan(tt, q, spans)))
    assert tmem.stats() == jmem.stats()


def test_traced_post_emits_the_reference_events():
    rng = np.random.RandomState(2)
    jp, tp = both_plans(rng, 16)
    got = []
    for o, mod, plan in ((jobs, jtr, jp), (obs, tr, tp)):
        with o.scope() as (tracer, _):
            with o.span("post"):
                mod.RemoteMemory().post(plan, tag="read")
        got.append([(e["name"], e["attrs"]) for e in tracer.spans[0].events])
    assert got[0] == got[1] and got[1]


def test_histogram_percentiles_match_reference():
    rng = np.random.RandomState(4)
    a, b = rng.lognormal(1.0, 1.2, 5000), rng.exponential(30.0, 777)
    a[:5] = 0.0                                   # underflow
    hj, ht = jobs.Histogram(), obs.Histogram()
    for h in (hj, ht):
        h.record_many(a)
        for v in b[:50]:
            h.record(v)
        other = type(h)()
        other.record_many(b[50:])
        h.merge(other)
    for q in (0, 1, 25, 50, 90, 99, 99.9, 100):
        assert ht.percentile(q) == hj.percentile(q)
    assert ht.to_dict() == hj.to_dict()
    assert obs.percentiles_from(ht) == jobs.percentiles_from(hj)
    reg_j, reg_t = jobs.MetricsRegistry(), obs.MetricsRegistry()
    for reg in (reg_j, reg_t):
        reg.counter("x", tag="a").inc(3)
        reg.gauge("g").set(2.5)
        reg.histogram("h").record_many(a[:100])
    assert reg_t.to_dict() == reg_j.to_dict()


@pytest.mark.parametrize("workload", sim.SIM_WORKLOADS)
def test_run_ycsb_matches_reference(workload):
    assert_cell_matches("continuity", workload)


def test_end_to_end_ordering_read_heavy():
    """The paper's ordering in the simulated model (LinkModel outputs):
    continuity >= level >= pfarm ops/s on B and C, and continuity's C p99
    at most both baselines'."""
    cells = {s: {wl: sim.run_ycsb(s, wl, device="cpu", **SMALL)
                 for wl in ("B", "C")}
             for s in ("continuity", "level", "pfarm")}
    for wl in ("B", "C"):
        c, l, p = (cells[s][wl]["ops_per_s"]
                   for s in ("continuity", "level", "pfarm"))
        assert c >= l >= p, (wl, c, l, p)
    assert (cells["continuity"]["C"]["p99_us"]
            <= cells["level"]["C"]["p99_us"])
    assert (cells["continuity"]["C"]["p99_us"]
            <= cells["pfarm"]["C"]["p99_us"])


def test_run_ycsb_rejects_unknown_mix_and_missing_card():
    with pytest.raises(ValueError, match="workload"):
        sim.run_ycsb("level", "Z", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only rule cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.run_ycsb("level", "C", **SMALL)
