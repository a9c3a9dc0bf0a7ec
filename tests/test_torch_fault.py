"""The port's fault runtime (`repro_torch.runtime.fault`) against the JAX
package's, on the CPU.

The intent of ``tests/test_fault.py`` and of the heartbeat cases of
``tests/test_chaos.py``, each run on both packages with the same clock
script and inputs: detection, the two-phase suspect -> failed window,
elastic remesh, replay-exact data order, straggler flags, and the
page-table restart drill over crash images of a continuity and a dense
shard (every recovered table byte-equal, the merged reports equal).
"""

import dataclasses

import numpy as np
import pytest

from repro import api as japi
from repro.runtime import fault as jfault
from repro_torch import api, convert
from repro_torch.consistency import crash_states, trace_batch
from repro_torch.consistency.schemes import HANDLERS
from repro_torch.data import ycsb
from repro_torch.runtime import fault

MODULES = [pytest.param(jfault, id="reference"), pytest.param(fault, id="port")]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _script(mod, grace):
    """One monitor under a scripted clock; returns what it reported."""
    clk = FakeClock()
    mon = mod.HeartbeatMonitor(timeout_s=5.0, clock=clk, grace_s=grace)
    out = []
    for h in ("pm0", "pm1", "pm2"):
        mon.register(h)
    for t, beats in ((3.0, ("pm0", "pm1")), (5.0, ()), (5.1, ()),
                     (8.0, ("pm2",)), (9.5, ()), (15.0, ()), (15.1, ()),
                     (23.1, ("pm1",)), (40.0, ())):
        clk.t = t
        for h in beats:
            mon.heartbeat(h, step=int(t))
        out.append((t, [mon.state(h) for h in sorted(mon.hosts)],
                    mon.suspect_hosts(), mon.failed_hosts(),
                    mon.suspicions_cleared))
    return out


@pytest.mark.parametrize("grace", [0.0, 10.0])
def test_heartbeat_states_match_reference(grace):
    assert _script(fault, grace) == _script(jfault, grace)


@pytest.mark.parametrize("mod", MODULES)
def test_heartbeat_detects_silence(mod):
    clk = FakeClock()
    mon = mod.HeartbeatMonitor(timeout_s=10, clock=clk)
    for h in ("host0", "host1", "host2"):
        mon.register(h)
    clk.t = 5
    mon.heartbeat("host0", 1)
    mon.heartbeat("host1", 1)
    clk.t = 12
    assert mon.failed_hosts() == ["host2"]
    clk.t = 25
    assert set(mon.failed_hosts()) == {"host0", "host1", "host2"}


@pytest.mark.parametrize("mod", MODULES)
def test_heartbeat_grace_two_phase_and_heal(mod):
    clk = FakeClock()
    mon = mod.HeartbeatMonitor(timeout_s=5.0, clock=clk, grace_s=10.0)
    mon.register("pm0")
    clk.t = 5.0                      # boundary is strict
    assert mon.state("pm0") == "alive"
    clk.t = 8.0                      # silent past timeout: suspect
    assert mon.suspect_hosts() == ["pm0"] and mon.failed_hosts() == []
    mon.heartbeat("pm0", step=1)     # heals inside the grace window
    assert mon.state("pm0") == "alive" and mon.suspicions_cleared == 1
    clk.t = 23.1
    assert mon.state("pm0") == "failed"


@pytest.mark.parametrize("case", [
    dict(total_chips=256, failed_chips=16, model_axis=16,
         checkpoint_step=900, current_step=942),
    dict(total_chips=512, failed_chips=20, model_axis=16,
         checkpoint_step=0, current_step=5, pod_axis=2),
    dict(total_chips=64, failed_chips=3, model_axis=8,
         checkpoint_step=10, current_step=10),
])
def test_remesh_matches_reference(case):
    got, want = fault.plan_remesh(**case), jfault.plan_remesh(**case)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.mesh_shape[-1] == case["model_axis"]


@pytest.mark.parametrize("mod", MODULES)
def test_remesh_exhaustion_raises(mod):
    with pytest.raises(RuntimeError):
        mod.plan_remesh(total_chips=16, failed_chips=15, model_axis=16,
                        checkpoint_step=0, current_step=0)


def test_deterministic_schedule_matches_reference():
    a = fault.DeterministicSchedule(seed=42, global_batch=256)
    b = jfault.DeterministicSchedule(seed=42, global_batch=256)
    for step, shard in ((10, 3), (11, 3), (10, 4)):
        np.testing.assert_array_equal(a.batch_indices(step, shard, 16),
                                      b.batch_indices(step, shard, 16))
    assert (a.batch_indices(10, 3, 16) != a.batch_indices(11, 3, 16)).any()


def _latency_monitor(mod):
    clk = FakeClock()
    mon = mod.HeartbeatMonitor(timeout_s=1e9, clock=clk)
    rng = np.random.RandomState(0)
    for h in range(8):
        mon.register(f"h{h}")
    for step in range(30):
        for h in range(8):
            lat = 100 + rng.rand() * 2 + (40 if h == 5 else 0)
            mon.heartbeat(f"h{h}", step, step_latency_ms=lat)
    return mon


def test_straggler_reports_match_reference():
    got = fault.StragglerPolicy(threshold=1.15).analyze(
        _latency_monitor(fault))
    want = jfault.StragglerPolicy(threshold=1.15).analyze(
        _latency_monitor(jfault))
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    assert [r.host for r in got] == ["h5"] and got[0].severity > 1.3


@pytest.mark.parametrize("scheme", ["continuity", "dense"])
def test_page_table_recovery_drill_matches_reference(scheme):
    """Crash images of one insert batch on a loaded shard (the continuity
    one with its stash engaged): the port's drill recovers every image to
    the reference's table, and the merged reports are equal."""
    slots = 40 if scheme == "continuity" else 64
    store = api.make_store(scheme, table_slots=slots, device="cpu")
    jstore = japi.make_store(scheme, table_slots=slots)
    assert dataclasses.asdict(store.cfg) == dataclasses.asdict(jstore.cfg)
    rng = np.random.RandomState(3)
    K = ycsb.make_key(np.arange(40))
    V = ycsb.make_value(rng, 40)
    table, _ = store.insert(store.create(), K, V)
    h = HANDLERS[scheme]
    base = h.init_state(store.cfg, table)
    K2 = ycsb.make_key(np.arange(100, 108))
    _, trace = trace_batch(h, store.cfg, base, "insert", K2,
                           ycsb.make_value(rng, 8), device="cpu")
    images = [cs.state for cs in crash_states(base, trace)]
    assert len(images) > 4
    tables, merged = fault.page_table_recovery_drill(store, images)
    jtables, jmerged = jfault.page_table_recovery_drill(jstore, images)
    assert dataclasses.asdict(merged) == dataclasses.asdict(jmerged)
    assert merged.log_free()
    to_np = (convert.table_to_numpy if scheme == "continuity"
             else convert.dense_table_to_numpy)
    for t, jt in zip(tables, jtables):
        got = to_np(t)
        for f in got:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(jt, f)))
    if scheme == "continuity":
        assert int((images[-1]["stash_meta"] != 0).sum()) > 0


def test_restart_matches_reference_recovery():
    """The port's one continuity restart (`continuity.restart`, what
    failover runs on the card at full size), given a table or a numpy
    crash state, recovers the reference's table and report — on every
    crash image of a stash-spilling update batch, and with stash entries
    that repeat a row key or each other."""
    store = api.make_store("continuity", table_slots=40, device="cpu")
    jstore = japi.make_store("continuity", table_slots=40)
    rng = np.random.RandomState(4)
    K = ycsb.make_key(np.arange(46))
    table, _ = store.insert(store.create(), K, ycsb.make_value(rng, 46))
    h = HANDLERS["continuity"]
    base = h.init_state(store.cfg, table)
    _, trace = trace_batch(h, store.cfg, base, "update", K[::3],
                           ycsb.make_value(rng, len(K[::3])), device="cpu")
    images = [cs.state for cs in crash_states(base, trace)]
    live = np.flatnonzero(base["stash_meta"])
    free = np.flatnonzero(base["stash_meta"] == 0)
    assert len(live) and len(free) >= 2
    dup = {f: v.copy() for f, v in base.items()}
    dup["stash_keys"][free[0]] = dup["stash_keys"][live[0]]
    dup["stash_meta"][free[0]] = dup["stash_meta"][live[0]]
    p = 0
    s = int(np.flatnonzero([(int(dup["indicator"][p]) >> i) & 1
                            for i in range(store.cfg.slots_per_pair)])[0])
    dup["stash_keys"][free[1]] = dup["keys"][p, s]
    dup["stash_meta"][free[1]] = p + 1
    cleared = 0
    for img in images + [dup]:
        jt, jr = jstore.recover(img)
        for given in (convert.table_from_numpy(img, "cpu"), img):
            t, r = store.recover(given)
            assert dataclasses.asdict(r) == dataclasses.asdict(jr)
            got = convert.table_to_numpy(t)
            for f in got:
                np.testing.assert_array_equal(got[f],
                                              np.asarray(getattr(jt, f)))
        state, r = h.recover(store.cfg, img)
        assert dataclasses.asdict(r) == dataclasses.asdict(jr)
        for f in got:
            np.testing.assert_array_equal(state[f], got[f])
        cleared += jr.duplicates_cleared
    assert cleared >= 2
