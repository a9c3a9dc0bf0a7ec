"""The port's crash-consistency subsystem against the JAX package's, on
the CPU.

Every cell of the crash matrix (4 schemes x insert/update/delete) and the
online split's resize cell give the reference's summary row, and every
traced batch is the reference's trace record for record: kind, address,
byte count, atomicity, Table-I counting and each payload write.  Then the
intent of ``tests/test_crash_consistency.py`` on the port: continuity
recovers from every crash point with zero log records, level and pfarm
need their logs, dense's torn in-place update is detected, traced ops
match untraced ones, recovery is idempotent, the wave and serial trace
orders land on one durable state, level's movement is crash-safe, and the
serving page table's allocation batch is crash-checkable.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.continuity as jch
from repro.consistency import matrix as jmatrix
from repro.consistency import schemes as jschemes
from repro_torch import api, convert
from repro_torch.consistency import crash_states, matrix, run_case, trace_batch
from repro_torch.consistency.schemes import HANDLERS
from repro_torch.consistency.trace import apply_trace
from repro_torch.core.hashfn import hash128, hash128_2
from repro_torch.data import ycsb

OPS = ("insert", "update", "delete")
SCHEMES = list(matrix.SHAPES)


def _loaded_store(scheme, table_slots=240, n_base=24, seed=7):
    store = api.make_store(scheme, table_slots=table_slots, device="cpu")
    rng = np.random.RandomState(seed)
    K = ycsb.make_key(np.arange(n_base))
    V = ycsb.make_value(rng, n_base)
    t, res = store.insert(store.create(), K, V)
    return store, t, K[res.ok.numpy()], rng


def _cell_batch(mod, scheme, op, **kw):
    """The matrix cell's store, table and batch, as ``mod._load`` makes
    them (``mod`` is the reference's matrix module or the port's)."""
    store, table, live_keys, n_ops, rng = mod._load(scheme, **kw)
    n = min(n_ops, live_keys.shape[0])
    if op == "insert":
        keys = ycsb.make_key(np.arange(1000, 1000 + n))
        vals = ycsb.make_value(rng, n)
    else:
        keys = live_keys[:n]
        vals = ycsb.make_value(rng, n) if op == "update" else None
    return store, table, keys, vals


def assert_traces_equal(jtr, ttr):
    assert (jtr.scheme, jtr.op, jtr.order) == (ttr.scheme, ttr.op, ttr.order)
    assert len(jtr.records) == len(ttr.records)
    for i, (a, b) in enumerate(zip(jtr.records, ttr.records)):
        assert (a.op_id, a.kind, a.atomic, int(a.addr), a.nbytes,
                a.counts_pm) == (b.op_id, b.kind, b.atomic, int(b.addr),
                                 b.nbytes, b.counts_pm), i
        assert len(a.writes) == len(b.writes), i
        for wa, wb in zip(a.writes, b.writes):
            assert wa.field == wb.field and wa.index == wb.index, i
            va, vb = np.asarray(wa.value), np.asarray(wb.value)
            assert va.dtype == vb.dtype and np.array_equal(va, vb), i
    assert ([dataclasses.astuple(o) for o in jtr.ops]
            == [dataclasses.astuple(o) for o in ttr.ops])


def assert_states_equal(a, b):
    assert set(a) == set(b)
    for f in a:
        assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), f


# ---------------------------------------------------------------------------
# the crash/scheme matrix against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_crash_matrix_cell_matches_reference(scheme, op):
    """The cell's summary row and its whole trace equal the reference's,
    and the cell meets its expectation."""
    r = matrix.run_cell(scheme, op, device="cpu")
    assert r.crash_points > 1
    assert matrix.cell_ok(r), (scheme, op, r.violations[:5],
                               r.log_used_points)
    assert matrix.summarize(r) == jmatrix.summarize(
        jmatrix.run_cell(scheme, op))
    js, jt, K, V = _cell_batch(jmatrix, scheme, op)
    ts, tt, K2, V2 = _cell_batch(matrix, scheme, op, device="cpu")
    assert np.array_equal(K, K2)
    jfinal, jtr = jschemes.trace_batch(jschemes.HANDLERS[scheme], js.cfg,
                                       jt, op, K, V)
    tfinal, ttr = trace_batch(HANDLERS[scheme], ts.cfg, tt, op, K2, V2,
                              device="cpu")
    assert_traces_equal(jtr, ttr)
    assert_states_equal(jfinal, tfinal)


def test_resize_cell_matches_reference():
    """The online split's crash cell: the row and the composite trace
    (cohort inserts, token stores, cohort deletes) equal the reference's."""
    from repro.consistency.split import build_split_trace as j_build
    from repro_torch.consistency.split import build_split_trace
    row = matrix.run_resize_cell("continuity", device="cpu")
    assert row == jmatrix.run_resize_cell("continuity")
    assert row["ok"] and row["log_free"] and row["torn_points"] > 0
    js, jt, _, _, _ = jmatrix._load("continuity")
    ts, tt, _, _, _ = matrix._load("continuity", device="cpu")
    jbase, jtr = j_build(js, jt)
    base, tr = build_split_trace(ts, tt)
    assert_states_equal(jbase, base)
    assert_traces_equal(jtr, tr)


def test_migrate_cell_rows_equal_reference():
    """The matrix runs the cluster's live-migration cell by default again,
    and its row equals the reference's field for field."""
    row = matrix.run_migration_cell("continuity", device="cpu")
    assert row == jmatrix.run_migration_cell("continuity")
    assert row["ok"] and row["consistent"] and row["log_free"]
    assert row["crash_points"] > row["torn_points"] > 0
    rows = matrix.run_rows(["continuity"], ("migrate",), device="cpu")
    assert rows == jmatrix.run_rows(["continuity"], ("migrate",))
    assert matrix.main(["--device", "cpu", "--schemes", "continuity",
                        "--ops", "migrate", "--quiet"]) == 0


@pytest.mark.parametrize("op", OPS)
def test_continuity_every_crash_point_log_free(op):
    """The headline claim: continuity recovers from EVERY prefix and torn
    split with zero log records anywhere, and recovery reads only the
    commit words."""
    r = matrix.run_cell("continuity", op, device="cpu")
    assert r.consistent, r.violations[:5]
    assert r.log_records_in_trace == 0
    assert r.log_used_points == 0
    assert r.report.log_records_scanned == 0
    assert r.report.payload_slots_scanned == 0
    assert r.report.commit_words_scanned > 0


def test_pfarm_recovery_requires_log_records():
    r = matrix.run_cell("pfarm", "insert", device="cpu")
    assert r.consistent
    assert r.log_records_in_trace > 0
    assert r.log_used_points > 0
    assert r.report.log_records_used > 0


def test_level_logged_update_fallback_uses_undo_log():
    r = matrix.run_cell("level", "update", device="cpu")
    assert r.consistent
    assert "logged" in r.paths
    assert r.log_used_points > 0


def test_dense_inplace_update_torn_hazard_detected():
    """Negative control: the unprotected dense in-place update MUST give
    detected violations, and only at torn crash points."""
    r = matrix.run_cell("dense", "update", device="cpu")
    assert not r.consistent
    assert all("torn" in v for v in r.violations)
    assert r.torn_points > 0


# ---------------------------------------------------------------------------
# trace <-> scheme equivalence and ledger reconciliation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
def test_traced_ops_match_untraced_ops(scheme):
    """store.trace_* gives the same ok flags, visible items, count and
    Table-I PM-write count as the untraced op, each from the same
    pre-state (both update their table in place)."""
    store, t, live, rng = _loaded_store(scheme)
    store = store.with_policy(api.ExecPolicy(engine="serial"))
    h = HANDLERS[scheme]
    pre = h.init_state(store.cfg, t)
    K2 = ycsb.make_key(np.arange(500, 510))
    V2 = ycsb.make_value(rng, 10)
    for op, keys, vals in (("insert", K2, V2), ("update", live[:10], V2),
                           ("delete", live[5:15], None)):
        t1 = h.state_to_table(store.cfg, pre, "cpu")
        t2 = h.state_to_table(store.cfg, pre, "cpu")
        args = (keys,) if vals is None else (keys, vals)
        t1b, tres = getattr(store, f"trace_{op}")(t1, *args)
        t2, res = getattr(store, op)(t2, *args)
        assert t1b is t1
        np.testing.assert_array_equal(tres.ok, res.ok.numpy())
        assert int(tres.ledger.pm_writes) == int(res.ledger.pm_writes)
        assert int(tres.ledger.ops) == int(res.ledger.ops)
        v1 = h.visible(store.cfg, h.init_state(store.cfg, t1))
        v2 = h.visible(store.cfg, h.init_state(store.cfg, t2))
        assert v1 == v2, (scheme, op)
        assert int(t1.count) == int(t2.count)


def test_trace_respects_exec_policy_order():
    store, t, live, rng = _loaded_store("continuity")
    K = ycsb.make_key(np.arange(500, 508))
    V = ycsb.make_value(rng, 8)
    pre = HANDLERS["continuity"].init_state(store.cfg, t)
    _, wres = store.trace_insert(t, K, V)
    _, sres = store.with_policy(api.ExecPolicy(engine="serial")).trace_insert(
        convert.table_from_numpy({f: pre[f] for f in t._fields}, "cpu"), K, V)
    assert wres.trace.order == "wave"
    assert sres.trace.order == "serial"


# ---------------------------------------------------------------------------
# recovery idempotence + serial/wave durable equivalence
# ---------------------------------------------------------------------------

def _op_batch(op, live, rng, ids):
    """One batch for ``op`` from id choices (one op per key)."""
    ids = np.asarray(ids)
    if op == "insert":
        return ycsb.make_key(1000 + ids), ycsb.make_value(rng, len(ids))
    keys = live[ids % live.shape[0]]
    _, first = np.unique(keys, axis=0, return_index=True)
    keys = keys[np.sort(first)]
    vals = ycsb.make_value(rng, keys.shape[0]) if op == "update" else None
    return keys, vals


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_recover_idempotent_fixed(scheme, op):
    """recover(recover(s)) == recover(s) on crash images."""
    store, t, live, rng = _loaded_store(scheme)
    h = HANDLERS[scheme]
    keys, vals = _op_batch(op, live, rng, [0, 3, 5, 7, 11, 13])
    base = h.init_state(store.cfg, t)
    _, trace = trace_batch(h, store.cfg, base, op, keys, vals, device="cpu")
    states = list(crash_states(base, trace))
    for crash_at in (0, 3, 10 ** 6):
        cs = states[crash_at % len(states)]
        once, _ = h.recover(store.cfg, cs.state)
        twice, _ = h.recover(store.cfg, once)
        assert_states_equal(once, twice)


@pytest.mark.parametrize("ids", [list(range(14)), [2, 9, 4, 30, 17]],
                         ids=["first14", "scattered"])
@pytest.mark.parametrize("op", OPS)
def test_serial_and_wave_traces_same_durable_state_fixed(op, ids):
    """The wave schedule lands on the serial order's durable state, every
    wave crash point recovers all-or-nothing, and the wave trace is the
    reference's record for record."""
    store, t, live, rng = _loaded_store("continuity")
    h = HANDLERS["continuity"]
    keys, vals = _op_batch(op, live, rng, ids)
    base = h.init_state(store.cfg, t)
    st_serial, tr_serial = trace_batch(h, store.cfg, base, op, keys, vals,
                                       order="serial", device="cpu")
    _, tr_wave = trace_batch(h, store.cfg, base, op, keys, vals,
                             order="wave", device="cpu")
    assert tr_wave.pm_writes() == tr_serial.pm_writes()
    assert_states_equal(st_serial, apply_trace(base, tr_wave))
    r = run_case(store, t, op, keys, vals, order="wave")
    assert r.consistent, r.violations[:5]
    jcfg = jch.ContinuityConfig(**dataclasses.asdict(store.cfg))
    _, jtr = jschemes.trace_batch(jschemes.HANDLERS["continuity"], jcfg,
                                  base, op, keys, vals, order="wave")
    assert_traces_equal(jtr, tr_wave)


# ---------------------------------------------------------------------------
# level movement: crash-safe 5-store order + duplicate-scan recovery
# ---------------------------------------------------------------------------

def test_level_movement_crash_safe_and_dedup():
    """A level insert on the one-movement path, crashed at every point:
    torn stores stay invisible and the transient duplicate of the moved
    item is repaired by recovery's duplicate scan."""
    store = api.make_store("level", table_slots=48, device="cpu")
    cfg = store.cfg
    h = HANDLERS["level"]
    rng = np.random.RandomState(3)
    state = h.init_state(cfg, store.create())
    K = ycsb.make_key(np.array([123]))
    V = ycsb.make_value(rng, 1)
    cand = h.route(cfg, K, "cpu")[0]
    M = None
    for i in range(5000):
        cM = ycsb.make_key(np.array([5000 + i]))
        w = torch.from_numpy(cM.view(np.int32))
        a1 = int(hash128(w)[0]) % cfg.num_top
        a2 = int(hash128_2(w)[0]) % cfg.num_top
        if a1 == int(cand[0]) and a2 != a1 and a2 not in set(
                int(c) for c in cand):
            M = cM
            break
    assert M is not None
    nxt = iter(range(9000, 9999))
    for j in range(4):
        kf, tf = ("tkeys", "ttok") if j < 2 else ("bkeys", "btok")
        b = int(cand[j])
        for s in range(cfg.bucket_slots):
            state[kf][b, s] = ycsb.make_key(np.array([next(nxt)]))[0]
        state[tf][b] = np.uint8((1 << cfg.bucket_slots) - 1)
    state["tkeys"][int(cand[0]), 0] = M[0]
    assert trace_batch(h, cfg, state, "insert", K, V,
                       device="cpu")[1].ops[0].path == "move"
    r = run_case(store, state, "insert", K, V)
    assert r.consistent, r.violations[:5]
    assert "move" in r.paths
    assert r.log_records_in_trace == 0          # movement is log-free
    assert r.report.duplicates_cleared > 0


# ---------------------------------------------------------------------------
# serving page table + restart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["continuity", "dense"])
def test_serving_page_table_crash_checkable(scheme):
    """``open_new_pages_traced`` maps the pages `open_new_pages` maps, and
    every crash image of a shard's allocation batch recovers log-free to
    exact page ids (the restart drill, `page_table_recovery_drill`, as
    the reference's)."""
    from repro import api as japi
    from repro.runtime.fault import page_table_recovery_drill as j_drill
    from repro_torch.configs import smoke_config
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime.fault import page_table_recovery_drill
    from repro_torch.serving import kvcache as KC

    cfg = smoke_config("yi-6b")
    shape = ShapeConfig("t", seq_len=128, global_batch=4, kind="decode")
    geom = KC.make_geometry(cfg, shape, shards=2, page_size=16,
                            scheme=scheme, device="cpu")
    h = HANDLERS[scheme]
    scfg = geom.store.cfg
    base_cache = KC.create_cache(geom)
    need = (base_cache.seq_lens % geom.page_size) == 0
    base = h.init_state(scfg, base_cache.table[0])
    ref = KC.open_new_pages(geom, KC.create_cache(geom), need)
    traced, traces = KC.open_new_pages_traced(geom, base_cache, need)
    for s in range(geom.shards):
        assert (h.visible(scfg, h.init_state(scfg, ref.table[s]))
                == h.visible(scfg, h.init_state(scfg, traced.table[s])))
    assert np.array_equal(ref.next_free.numpy(), traced.next_free.numpy())
    assert np.array_equal(ref.cur_page.numpy(), traced.cur_page.numpy())
    images = [cs.state for cs in crash_states(base, traces[0].trace)]
    assert len(images) > 2
    tables, merged = page_table_recovery_drill(geom.store, images)
    assert len(tables) == len(images)
    for tbl in tables:
        for k, v in h.visible(scfg, h.init_state(scfg, tbl)).items():
            assert len(v) == 16
    assert merged.log_records_used == 0          # log-free at serving scale
    # the drill is the reference's: the same merged report on the images
    jstore = japi.make_store(scheme, table_slots=KC.page_table_slots(
        geom.batch_per_shard * geom.max_pages))
    assert dataclasses.asdict(jstore.cfg) == dataclasses.asdict(scfg)
    _, jmerged = j_drill(jstore, images)
    assert dataclasses.asdict(merged) == dataclasses.asdict(jmerged)


def test_store_recover_accepts_tables_and_reports():
    store, t, live, _ = _loaded_store("continuity")
    t2, rep = store.recover(t)
    assert rep.log_free()
    assert t2 is not t and int(t2.count) == int(t.count)
    t3, _ = store.recover(t2)
    for a, b in zip(t2, t3):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
