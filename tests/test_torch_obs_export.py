"""The port's telemetry export and report (`repro_torch.obs.export`,
`repro_torch.obs.report`) and the cluster's metrics against the JAX
package's, on the CPU.

The intent of the export and cluster cases of ``tests/test_obs.py``: a
traced cluster run under a `TickClock` exports byte-identical trace and
metrics JSON for the same seed — and byte-identical to the reference's
export of the same run; ``python -m repro_torch.obs.report BASE --check``
passes on the ``cluster.sim --smoke --trace`` export and prints what the
reference's report prints for it; the gate fails on broken exports as the
reference's does; a cluster's `metrics_view` sums its node endpoints; and
the online split under traffic counts its maintenance-SLO burns (zero at
the default SLO) as the reference does, every node table byte-equal.
"""

import json

import numpy as np
import pytest

from repro import obs as jobs
from repro.cluster import sim as jsim
from repro.obs import report as jreport
from repro_torch import obs
from repro_torch.cluster import sim
from repro_torch.cluster.store import ClusterStore
from repro_torch.data import ycsb
from repro_torch.obs import report
from test_torch_cluster import PORT, REF, assert_same, both, result, snapshot


def _traced_cluster(o, s, seed, **kw):
    with o.scope(o.Tracer(o.TickClock())) as (tracer, reg):
        s.run_cluster("continuity", "A", nodes=3, replicas=2,
                      num_records=240, num_ops=480, batch=120,
                      node_slots=768, seed=seed,
                      events=(("join", 160, "pmJ"), ("kill", 320, "primary")),
                      **kw)
        return o.export_strings(tracer, reg, meta={"seed": seed})


def test_same_seed_exports_are_byte_identical_and_the_references():
    t1, m1 = _traced_cluster(obs, sim, 5, device="cpu")
    t2, m2 = _traced_cluster(obs, sim, 5, device="cpu")
    assert t1 == t2 and m1 == m2
    jt, jm = _traced_cluster(jobs, jsim, 5)
    assert t1 == jt and m1 == jm
    t3, m3 = _traced_cluster(obs, sim, 6, device="cpu")
    assert m3 != m1                          # different seed, different data
    spans = {e["name"] for e in json.loads(t1)["traceEvents"]
             if e["ph"] == "X"}
    assert {"cluster.round", "cluster.write", "cluster.read",
            "cluster.join.copy", "cluster.failover",
            "cluster.audit"} <= spans


@pytest.fixture(scope="module")
def smoke_export(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("obs") / "smoke")
    assert sim.main(["--smoke", "--device", "cpu", "--trace", base]) == 0
    return base


def test_report_check_passes_on_the_smoke_export(smoke_export, capsys):
    assert report.main([smoke_export, "--check"]) == 0
    ours = capsys.readouterr().out
    assert jreport.main([smoke_export, "--check"]) == 0
    assert ours == capsys.readouterr().out
    trace, metrics = obs.load_export(smoke_export + obs.TRACE_SUFFIX)
    assert report.span_table(trace) == jreport.span_table(trace)
    ratios = report.e2e_ratios(metrics)
    assert ratios == jreport.e2e_ratios(metrics)
    assert ratios["A"]["continuity"] <= ratios["A"]["level"] \
        <= ratios["A"]["pfarm"]
    assert report.slo_burns(metrics) == 0
    assert metrics["meta"]["profile"] == "smoke"


def test_report_check_fails_on_broken_exports(tmp_path, capsys):
    base = str(tmp_path / "broken")
    with obs.scope(obs.Tracer(obs.TickClock())) as (tracer, reg):
        obs.write_export(base + obs.METRICS_SUFFIX, tracer, reg)
    assert report.main([base, "--check"]) == 1       # no spans, no metrics
    assert jreport.main([base, "--check"]) == 1
    (tmp_path / ("broken" + obs.METRICS_SUFFIX)).unlink()
    assert report.main([base, "--check"]) == 1
    assert obs.load_export(base)[1] is None
    capsys.readouterr()


def test_cluster_metrics_view_sums_node_endpoints():
    views = []
    for P in (REF, PORT):
        cluster = P["C"]("continuity", nodes=3, replicas=2, node_slots=512)
        rng = np.random.RandomState(0)
        keys = ycsb.make_key(np.arange(96))
        cluster.insert(keys, ycsb.make_value(rng, 96))
        cluster.lookup(keys[:32])
        views.append(cluster.metrics_view())
        per_node = [n.mem.metrics for n in cluster._nodes.values()]
        want = sum(r.counter("rdma.posts").value for r in per_node)
        assert want > 0 and views[-1].counter("rdma.posts").value == want
        assert views[-1].histogram("rdma.post_us").count == sum(
            r.histogram("rdma.post_us").count for r in per_node)
    assert views[0].to_dict() == views[1].to_dict()
    assert isinstance(ClusterStore("continuity", nodes=1, replicas=1,
                                   node_slots=64, device="cpu"
                                   ).metrics_view(), obs.MetricsRegistry)


def scen_maintenance(P, slo):
    with P["obs"].scope() as (_, reg):
        c = P["C"]("continuity", nodes=1, replicas=1, node_slots=256)
        node = c.node("pm0")
        rng = np.random.RandomState(0)
        next_id = 0
        while float(np.asarray(node.store.load_factor(node.table))) <= 0.86 \
                and next_id < 2048:
            ids = np.arange(next_id, next_id + 64)
            next_id += 64
            c.insert(ycsb.make_key(ids), ycsb.make_value(rng, 64))
        log = []
        for step in range(200):
            acts = c.maintenance_step(budget=2, step_slo_us=slo)
            log.append(acts)
            if step % 4 == 1:             # traffic routed by the tokens
                ids = np.arange(next_id, next_id + 16)
                next_id += 16
                log.append(result(c.insert(ycsb.make_key(ids),
                                           ycsb.make_value(rng, 16))))
                log.append(result(c.lookup(ycsb.make_key(ids - 40))))
                log.append(result(c.lookup_stamped(ycsb.make_key(ids - 8))))
                log.append(result(c.version_read(ycsb.make_key(ids))))
                log.append(snapshot(c))
            if not acts:
                break
        log += [dict(c.maintenance),
                reg.counter("maintenance.slo_burn").value,
                result(c.lookup(ycsb.make_key(np.arange(next_id)))),
                snapshot(c)]
    return log


@pytest.mark.parametrize("slo", [None, 1e-3], ids=["default", "tiny"])
def test_online_split_under_traffic_matches_reference(slo):
    ref, port = both(scen_maintenance, slo=slo)
    assert_same(ref, port)
    m = port[-4]
    assert m["resizes_begun"] == m["cutovers"] == 1 and m["steps"] >= 1
    assert (m["slo_burns"] > 0) == (slo is not None)
    assert port[-3] == m["slo_burns"]
    assert port[-2]["found"].sum() == \
        port[-1]["stats"]["nodes"]["pm0"]["resident"]
