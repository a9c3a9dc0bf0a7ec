"""The port's maintenance surface against the JAX package, on the CPU.

The intent of ``tests/test_resize.py`` (its cluster test aside, which
waits for the cluster layer): the begin/step/cutover triple on every
scheme, the deprecated one-shot shim, per-cohort incrementality, writes
during a split, the mid-split crash cell, the plan trio and the stash
tier's API-visible effects — each held byte for byte against the
reference's tables and results.  Plus the continuity primitives under the
protocol (``resize`` in chunks, ``resize_stepwise``, ``recover``,
``insert_parallel``) and version seeding above 2**31.
"""

import dataclasses
import inspect
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.continuity as ch
from repro import api as japi
from repro.data import ycsb
import repro_torch.core.continuity as tch
from repro_torch import api, convert
from repro_torch.api.types import ResizeState
from repro_torch.consistency.matrix import run_resize_cell
from repro_torch.rdma.verbs import VerbPlan
from test_torch_continuity import (assert_same, assert_tables_equal, cfgs,
                                   keys_vals, np_fields)

SCHEMES = ("continuity", "level", "pfarm", "dense")
TO_NUMPY = {"continuity": convert.table_to_numpy,
            "level": convert.level_table_to_numpy,
            "pfarm": convert.pfarm_table_to_numpy,
            "dense": convert.dense_table_to_numpy}


def assert_store_tables_equal(scheme, jt, tt):
    want, got = np_fields(jt), TO_NUMPY[scheme](tt)
    bad = [f for f in want if want[f].dtype != got[f].dtype
           or not np.array_equal(want[f], got[f])]
    assert not bad, f"fields differ: {bad}"


def stores(scheme, table_slots, engine="wave"):
    return (japi.make_store(scheme, table_slots=table_slots,
                            policy=japi.ExecPolicy(engine=engine)),
            api.make_store(scheme, table_slots=table_slots,
                           policy=api.ExecPolicy(engine=engine),
                           device="cpu"))


def seeded(js, ts, n, seed=3):
    rng = np.random.RandomState(seed)
    K = ycsb.make_key(np.arange(n))
    V = ycsb.make_value(rng, n)
    jt, jres = js.insert(js.create(), K, V)
    tt, tres = ts.insert(ts.create(), K, V)
    okn = np.asarray(jres.ok)
    assert np.array_equal(okn, tres.ok.numpy())
    return jt, tt, K[okn], V[okn], rng


# -- the begin/step/cutover triple ---------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
def test_incremental_triple_preserves_members(scheme):
    js, ts = stores(scheme, 160)
    jt, tt, K, V, _ = seeded(js, ts, 40)
    jrs, rs = js.begin_resize(jt), ts.begin_resize(tt)
    assert isinstance(rs, ResizeState) and not rs.done
    assert rs.n_items == jrs.n_items == len(K)
    steps = 0
    while not rs.done:
        jrs = js.resize_step(jrs, budget=1)
        rs = ts.resize_step(rs, budget=1)
        assert (rs.done, rs.moved) == (jrs.done, jrs.moved)
        steps += 1
        assert steps <= 10_000
    jns, jnt = js.resize_cutover(jrs)
    new_store, new_table = ts.resize_cutover(rs)
    assert new_store.cfg == dataclasses.replace(
        ts.cfg, **{f.name: getattr(jns.cfg, f.name)
                   for f in dataclasses.fields(jns.cfg)})
    assert new_store.total_slots() > ts.total_slots()
    assert_store_tables_equal(scheme, jnt, new_table)
    res = new_store.lookup(new_table, K)
    assert res.ok.all()
    assert (res.values.numpy().view(np.uint32) == V).all()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_step_replayed_from_begin_handle_holds_each_item_once(scheme):
    """A crash between steps resumes from an older handle: replaying the
    steps from the begin handle leaves the reference's grown table (no
    item inserted twice), and cutover holds each item once."""
    js, ts = stores(scheme, 160)
    jt, tt, K, V, _ = seeded(js, ts, 40)
    jrs, begin = js.begin_resize(jt), ts.begin_resize(tt)
    rs = ts.resize_step(begin, budget=1)
    rs = ts.resize_step(begin, budget=1)        # the replay
    while not rs.done:
        rs = ts.resize_step(rs, budget=1)
    while not jrs.done:
        jrs = js.resize_step(jrs, budget=1)
    _, jnt = js.resize_cutover(jrs)
    new_store, new_table = ts.resize_cutover(rs)
    assert_store_tables_equal(scheme, jnt, new_table)
    assert int(new_table.count) == len(K)
    res = new_store.lookup(new_table, K)
    assert res.ok.all()
    assert (res.values.numpy().view(np.uint32) == V).all()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_deprecated_resize_shim_warns_and_matches(scheme):
    js, ts = stores(scheme, 160)
    jt, tt, K, V, _ = seeded(js, ts, 40)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        new_store, new_table = ts.resize(tt)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        _, jnt = js.resize(jt)
    assert_store_tables_equal(scheme, jnt, new_table)
    res = new_store.lookup(new_table, K)
    assert res.ok.all()
    assert (res.values.numpy().view(np.uint32) == V).all()


def test_continuity_split_is_actually_incremental():
    """budget=1 advances exactly one cohort: both tables equal the
    reference's after every step, and dual-read serves the full item set
    at every intermediate."""
    js, ts = stores("continuity", 160)
    jt, tt, K, V, _ = seeded(js, ts, 40)
    cohorts = ts.cfg.num_pairs
    jrs, rs = js.begin_resize(jt), ts.begin_resize(tt)
    for step in range(cohorts):
        assert not rs.done
        jrs = js.resize_step(jrs, budget=1)
        rs = ts.resize_step(rs, budget=1)
        assert_tables_equal(jrs.table, rs.table)
        assert_tables_equal(jrs.new_table, rs.new_table)
        res, jres = ts.resize_lookup(rs, K), js.resize_lookup(jrs, K)
        assert res.ok.all(), f"lost keys after cohort {step}"
        assert (res.values.numpy().view(np.uint32) == V).all()
        assert_same(jres.reads, res.reads)
        assert all(np.array_equal(np.asarray(a), b.numpy())
                   for a, b in zip(jres.plan, res.plan))
    assert rs.done and rs.moved == len(K)
    assert int(rs.table.count) == 0          # the source drained
    new_store, new_table = ts.resize_cutover(rs)
    assert new_store.lookup(new_table, K).ok.all()


def test_step_slo_sizes_the_budget_like_the_reference():
    js, ts = stores("continuity", 160)
    jt, tt, _, _, _ = seeded(js, ts, 40)
    for slo in (0.1, 5.0, 40.0):
        assert (ts.begin_resize(tt, step_slo_us=slo).step_budget
                == js.begin_resize(jt, step_slo_us=slo).step_budget)
    assert ts.begin_resize(tt).step_budget is None


# -- writes during the split window --------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_write_during_split_never_loses_or_duplicates(seed):
    """Interleave foreground writes with cohort moves: the grown table
    holds EXACTLY the oracle (no lost ack, no phantom, no key twice), and
    every intermediate state equals the reference's."""
    rng = np.random.RandomState(seed)
    js, ts = stores("continuity", 240)
    n0 = 100
    K = ycsb.make_key(np.arange(n0))
    V = ycsb.make_value(rng, n0)
    jt, jres = js.insert(js.create(), K, V)
    tt, res = ts.insert(ts.create(), K, V)
    okn = res.ok.numpy()
    oracle = {int(i): v for i, v, o in zip(np.arange(n0), V, okn) if o}
    jrs, rs = js.begin_resize(jt), ts.begin_resize(tt)
    next_new = 1000
    while not rs.done:
        op = ("insert", "update", "delete")[rng.randint(3)]
        if op == "insert" or not oracle:
            op, kid = "insert", next_new
            next_new += 1
        else:
            kid = sorted(oracle)[rng.randint(len(oracle))]
        k = ycsb.make_key(np.array([kid]))
        v = ycsb.make_value(rng, 1)
        vv = None if op == "delete" else v
        jrs, jr = js.resize_write(jrs, op, k, vv)
        rs, r = ts.resize_write(rs, op, k, vv)
        assert bool(r.ok[0]) == bool(np.asarray(jr.ok)[0])
        assert int(r.ledger.pm_writes) == int(jr.ledger.pm_writes)
        if bool(r.ok[0]):
            if op == "delete":
                oracle.pop(kid, None)
            else:
                oracle[kid] = v[0]
        jrs = js.resize_step(jrs, budget=1)
        rs = ts.resize_step(rs, budget=1)
        if oracle:       # dual-read spot check mid-split
            probe = sorted(oracle)[rng.randint(len(oracle))]
            lr = ts.resize_lookup(rs, ycsb.make_key(np.array([probe])))
            assert bool(lr.ok[0])
            assert (lr.values.numpy()[0].view(np.uint32)
                    == oracle[probe]).all()
    assert_tables_equal(jrs.table, rs.table)
    assert_tables_equal(jrs.new_table, rs.new_table)
    new_store, new_table = ts.resize_cutover(rs)
    ids = np.array(sorted(oracle))
    lr = new_store.lookup(new_table, ycsb.make_key(ids))
    assert lr.ok.all(), "acked key lost across the split"
    want = np.stack([oracle[int(i)] for i in ids])
    assert (lr.values.numpy().view(np.uint32) == want).all()
    k2, _, live = new_store._extract(new_table)
    kb = [k.tobytes() for k in k2[live].numpy()]
    assert len(kb) == len(set(kb)), "duplicate key after cutover"
    assert len(kb) == len(oracle), "phantom keys after cutover"


def test_mid_split_crash_cell_green():
    """The crash cell of the split (its row equals the reference's in
    ``tests/test_torch_crash_consistency.py``)."""
    row = run_resize_cell("continuity", device="cpu")
    assert row["ok"] and row["consistent"] and row["log_free"]
    assert row["violations"] == 0
    assert row["crash_points"] > 0 and row["torn_points"] > 0


# -- the unified plan-emitting trio --------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
def test_plan_trio_unified_signature(scheme):
    """Every scheme module emits its three verb plans through ONE shape:
    ``fn(cfg, table, keys, ...) -> VerbPlan`` with batch == B, each equal
    to the reference's."""
    js, ts = stores(scheme, 160)
    jt, tt, K, _, _ = seeded(js, ts, 24)
    jmod, mod = js._mod, ts._mod
    B = K.shape[0]
    for name in ("lookup_plan", "version_read_plan", "scan_plan"):
        assert len(inspect.signature(getattr(mod, name)).parameters) >= 3
    spans = np.ones((B,), np.int64)
    plans = [
        mod.lookup_plan(ts.cfg, tt, K, mod.lookup(ts.cfg, tt, K)),
        mod.version_read_plan(ts.cfg, tt, K),
        mod.scan_plan(ts.cfg, tt, K, spans),
    ]
    jplans = [
        jmod.lookup_plan(js.cfg, jt, K, jmod.lookup(js.cfg, jt, K)),
        jmod.version_read_plan(js.cfg, jt, K),
        jmod.scan_plan(js.cfg, jt, K, spans),
    ]
    for name, plan, jplan in zip(("lookup", "version_read", "scan"), plans,
                                 jplans):
        assert isinstance(plan, VerbPlan), (scheme, name)
        assert plan.batch == B, (scheme, name)
        for a, b in zip(jplan, plan):
            assert np.array_equal(np.asarray(a), b.numpy()), (scheme, name)
    assert isinstance(ts.version_read_plan(tt, K), VerbPlan)
    assert isinstance(ts.scan_plan(tt, K, spans), VerbPlan)


# -- fingerprint/stash tier at the API boundary --------------------------

def test_stash_free_config_plan_bytes_unchanged():
    """stash_frac=0 (the core default) keeps the pre-stash wire contract:
    a (B, 2) plan — main segment + conditional ext lane."""
    cfg = tch.ContinuityConfig(num_buckets=16)
    assert cfg.stash_frac == 0.0 and cfg.stash_slots == 0
    rng = np.random.RandomState(0)
    K = ycsb.make_key(np.arange(32))
    table = tch.create(cfg, "cpu")
    tch.insert(cfg, table, K, ycsb.make_value(rng, 32))
    res = tch.lookup(cfg, table, K)
    assert tch.lookup_plan(cfg, table, K, res).verb.shape == (32, 2)


def test_api_store_carries_stash_tier():
    js, ts = stores("continuity", 160)
    assert ts.cfg.stash_slots > 0        # from_slots defaults 1/8
    _, tt, K, V, _ = seeded(js, ts, 40)
    res = ts.lookup(tt, K)
    assert res.ok.all()
    assert res.plan.verb.shape[1] == 3   # the stash lane rides along


def test_wave_serial_identical_with_stash_engaged():
    """Overfill a tiny table so inserts spill into the stash tier; the
    wave and serial engines give bit-identical state, the reference's."""
    out = {}
    for engine in ("serial", "wave"):
        js, ts = stores("continuity", 64, engine)
        rng = np.random.RandomState(9)
        K = ycsb.make_key(np.arange(90))
        V = ycsb.make_value(rng, 90)
        jt, jres = js.insert(js.create(), K, V)
        tt, res = ts.insert(ts.create(), K, V)
        assert_tables_equal(jt, tt)
        assert_same(jres.ok, res.ok)
        out[engine] = (tt, res.ok.numpy())
    (t_s, ok_s), (t_w, ok_w) = out["serial"], out["wave"]
    assert (ok_s == ok_w).all()
    assert int((t_s.stash_meta != 0).sum()) > 0, \
        "test did not actually engage the stash tier"
    for f in t_s._fields:
        assert np.array_equal(getattr(t_s, f).numpy(),
                              getattr(t_w, f).numpy()), f


def test_load_factor_first_trigger_past_085():
    """With fingerprints + stash the first insert failure lands past 0.85
    load factor, at the reference's load factor."""
    js, ts = stores("continuity", 256)
    jt, tt = js.create(), ts.create()
    rng = np.random.RandomState(4)
    step = 16
    first_reject_lf = None
    for lo in range(0, 2048, step):
        K = ycsb.make_key(np.arange(lo, lo + step))
        V = ycsb.make_value(rng, step)
        jt, jres = js.insert(jt, K, V)
        tt, res = ts.insert(tt, K, V)
        assert_same(jres.ok, res.ok)
        if not res.ok.all():
            first_reject_lf = float(ts.load_factor(tt))
            assert first_reject_lf == float(js.load_factor(jt))
            break
    assert first_reject_lf is not None, "table never filled"
    assert first_reject_lf >= 0.85, first_reject_lf


# -- the continuity primitives under the protocol ------------------------

def _loaded(num_buckets=16, n=150, stash=1 / 8, versions=None):
    jcfg, tcfg = cfgs(num_buckets=num_buckets, ext_frac=0.5,
                      stash_frac=stash)
    K, V = keys_vals(np.arange(n))
    jt, _, _ = ch.insert(jcfg, ch.create(jcfg), K, V)
    if versions is not None:
        v = np.asarray(jt.version).copy()
        v[:len(versions)] = versions
        jt = jt._replace(version=jnp.asarray(v))
    return jcfg, tcfg, jt, convert.table_from_numpy(np_fields(jt), "cpu"), K


@pytest.mark.parametrize("versions", [
    None, [0x80000000], [0xFFFFFF00, 0x80000001], [0xFFFFFFFF]],
    ids=["small", "2^31", "near-wrap", "wrap"])
@pytest.mark.parametrize("chunk", [1 << 22, 7])
def test_resize_seeds_versions_unsigned(versions, chunk):
    """``resize`` and ``split_begin`` seed every version one above the old
    table's UNSIGNED maximum, wrapping as the reference's uint32 add; the
    resized table equals the reference's whether the items go in as one
    batch or in chunks."""
    jcfg, tcfg, jt, tt, K = _loaded(versions=versions)
    before = convert.table_to_numpy(tt)
    jn = ch.resize(jcfg, jt)
    tn = tch.resize(tcfg, tt, chunk=chunk)
    assert tn[0] == tch.ContinuityConfig(**dataclasses.asdict(jn[0]))
    assert_tables_equal(jn[1], tn[1])
    for f, a in convert.table_to_numpy(tt).items():   # the source is intact
        assert np.array_equal(a, before[f]), f
    top = int(before["version"].max())
    fresh = convert.table_to_numpy(tch.split_begin(tcfg, tt)[1])["version"]
    assert (fresh == np.uint32((top + 1) % 2 ** 32)).all()
    assert_same(ch.split_begin(jcfg, jt)[1].version,
                tch.split_begin(tcfg, tt)[1].version)


def test_extract_items_and_items_host_match_reference():
    for stash in (0.0, 1 / 8):
        jcfg, tcfg, jt, tt, _ = _loaded(stash=stash)
        for a, b in zip(ch.extract_items(jcfg, jt),
                        tch.extract_items(tcfg, tt)):
            assert_same(a, b)
        assert ch.items_host(jcfg, jt) == tch.items_host(tcfg, tt)


def test_split_step_budgets_and_lookup_match_reference():
    jcfg, tcfg, jt, tt, K = _loaded(n=150)
    nc, nt, st = ch.split_begin(jcfg, jt)
    tnc, tnt, tst = tch.split_begin(tcfg, tt)
    while not ch.split_done(jcfg, st):
        jt, nt, st, m1 = ch.split_step(jcfg, jt, nc, nt, st, 3)
        tt, tnt, tst, m2 = tch.split_step(tcfg, tt, tnc, tnt, tst, 3)
        assert m1 == m2 and int(st.next_pair) == tst.next_pair
        assert_same(st.token, tst.token)
        assert_tables_equal(jt, tt)
        assert_tables_equal(nt, tnt)
        for a, b in zip(ch.split_lookup(jcfg, jt, nc, nt, st, K),
                        tch.split_lookup(tcfg, tt, tnc, tnt, tst, K)):
            assert_same(a, b)
    assert tch.split_done(tcfg, tst)


def test_resize_stepwise_and_recover_match_reference():
    jcfg, tcfg, jt, tt, _ = _loaded(num_buckets=8, n=30)
    ncfg, tncfg = jcfg.grow(2), tcfg.grow(2)
    jnew, tnew = ch.create(ncfg), tch.create(tncfg, "cpu")
    jt, jnew, m1 = ch.resize_stepwise(jcfg, jt, ncfg, jnew, 8)
    tt2, tnew2, m2 = tch.resize_stepwise(tcfg, tt, tncfg, tnew, 8)
    assert tt2 is tt and tnew2 is tnew and m1 == m2 == 8
    assert_tables_equal(jt, tt)
    assert_tables_equal(jnew, tnew)
    jt, jnew = ch.recover(jcfg, jt, ncfg, jnew)
    tch.recover(tcfg, tt, tncfg, tnew)
    assert_tables_equal(jt, tt)
    assert_tables_equal(jnew, tnew)
    assert int(tt.count) == 0 and int(tnew.count) == 30


def test_insert_parallel_matches_reference():
    jcfg, tcfg = cfgs(num_buckets=16, ext_frac=0.5)
    K, V = keys_vals(np.concatenate([np.arange(60), [3, 3, 7]]))
    jt, jok, jretry = ch.insert_parallel(jcfg, ch.create(jcfg), K, V)
    tt = tch.create(tcfg, "cpu")
    tt2, tok, tretry = tch.insert_parallel(tcfg, tt, K, V)
    assert tt2 is tt
    assert_tables_equal(jt, tt)
    assert_same(jok, tok)
    assert_same(jretry, tretry)
    assert int(tretry.sum()) > 0
