"""The port's level, P-FaRM-KV and dense baselines against the JAX package's,
on the CPU.

The same numpy-seeded batches go through both packages: every table field
must be byte-equal after each insert / update / delete batch (compared
through ``convert.*_to_numpy``), and so must ``ok``, the `CostLedger`,
lookups and their verb plans.  The sweeps reach level's one-movement
insert (5 PM writes) and logged update (4), pfarm's displacement, chain
append, fresh block allocation and full pool, masks and duplicate keys.
The last part ports the intent of ``tests/test_baselines.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.dense as jdn
import repro.core.level as jlv
import repro.core.pfarm as jpf
from repro.data import ycsb
from repro_torch import api, convert
from repro_torch.core import dense as dn
from repro_torch.core import level as lv
from repro_torch.core import pfarm as pf
from repro_torch.kernels import scan_walk

MODS = {
    "level": (jlv, lv, convert.level_table_to_numpy,
              lambda B: jlv.LevelConfig(num_top=max(8, B // 4)),
              lambda c: lv.LevelConfig(num_top=c.num_top)),
    "pfarm": (jpf, pf, convert.pfarm_table_to_numpy,
              lambda B: jpf.PFarmConfig(num_buckets=max(16, B // 4)),
              lambda c: pf.PFarmConfig(num_buckets=c.num_buckets)),
    "dense": (jdn, dn, convert.dense_table_to_numpy,
              lambda B: jdn.DenseConfig(capacity=B),
              lambda c: dn.DenseConfig(capacity=c.capacity)),
}


def kv(ids, seed=0):
    ids = np.asarray(ids)
    return ycsb.make_key(ids), ycsb.make_value(np.random.RandomState(seed),
                                               len(ids))


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same_words(want, got):
    w, g = np.asarray(want), np_of(got)
    if w.dtype == np.uint32:
        g = g.astype(np.int64).astype(np.uint32)
    np.testing.assert_array_equal(g, w)


def assert_tables_equal(jt, tt, to_numpy):
    got = to_numpy(tt)
    assert set(got) == set(jt._fields)
    for f in jt._fields:
        w = np.asarray(getattr(jt, f))
        assert got[f].dtype == w.dtype, f
        np.testing.assert_array_equal(got[f], w, err_msg=f)


def assert_op_equal(jout, tout):
    (_, jok, jctr), (_, tok, tctr) = jout, tout
    np.testing.assert_array_equal(np_of(tok), np.asarray(jok))
    assert [int(x) for x in tctr] == [int(x) for x in jctr]


def assert_reads_equal(scheme, jmod, tmod, jcfg, tcfg, jt, tt, q, spans):
    jr, tr = jmod.lookup(jcfg, jt, q), tmod.lookup(tcfg, tt, q)
    for f in jr._fields:
        same_words(getattr(jr, f), getattr(tr, f))
    plans = [(jmod.lookup_plan(jcfg, jt, q, jr),
              tmod.lookup_plan(tcfg, tt, q, tr)),
             (jmod.version_read_plan(jcfg, jt, q),
              tmod.version_read_plan(tcfg, tt, q)),
             (jmod.scan_plan(jcfg, jt, q, spans),
              tmod.scan_plan(tcfg, tt, q, spans))]
    for jp, tp in plans:
        for name, a, b in zip(jp._fields, jp, tp):
            same_words(a, b)
    return tr


def run_sweep(scheme, B, masked, dups, seed=0):
    """Two insert batches (the second overfills the table), an update and
    a delete batch, then lookups: both packages step by step."""
    jmod, tmod, to_numpy, mk_cfg, port_cfg = MODS[scheme]
    jcfg = mk_cfg(B)
    tcfg = port_cfg(jcfg)
    rng = np.random.RandomState(seed)
    jt, tt = jmod.create(jcfg), tmod.create(tcfg, "cpu")
    ledgers = {}

    def batch(ids, vseed):
        ids = np.asarray(ids)
        if dups:
            ids[rng.choice(len(ids), len(ids) // 8, replace=False)] = \
                ids[rng.randint(0, len(ids), len(ids) // 8)]
        k, v = kv(ids, vseed)
        mask = rng.rand(len(ids)) < 0.8 if masked else None
        return k, v, mask

    steps = [("insert", np.arange(B)), ("insert", np.arange(B, 2 * B)),
             ("update", rng.permutation(2 * B)[:B]),
             ("delete", rng.permutation(2 * B)[:B])]
    for i, (op, ids) in enumerate(steps):
        k, v, mask = batch(ids, seed + 10 + i)
        if op == "delete":
            jout = jmod.delete(jcfg, jt, k, mask)
            tout = tmod.delete(tcfg, tt, k, mask)
        else:
            jout = getattr(jmod, op)(jcfg, jt, k, v, mask)
            tout = getattr(tmod, op)(tcfg, tt, k, v, mask)
        assert tout[0] is tt                     # updated in place
        jt = jout[0]
        assert_op_equal(jout, tout)
        assert_tables_equal(jt, tt, to_numpy)
        ledgers.setdefault(op, []).append(tout)
    q = np.concatenate([kv(np.arange(2 * B))[0],
                        ycsb.negative_keys(rng, 2 * B, B // 2)])
    spans = ycsb.scan_lengths(rng, len(q))
    assert_reads_equal(scheme, jmod, tmod, jcfg, tcfg, jt, tt, q, spans)
    return tcfg, tt, ledgers


@pytest.mark.parametrize("B", [64, 512])
@pytest.mark.parametrize("masked,dups", [(False, False), (True, False),
                                         (False, True), (True, True)])
@pytest.mark.parametrize("scheme", ["level", "pfarm", "dense"])
def test_matches_reference(scheme, B, masked, dups):
    run_sweep(scheme, B, masked, dups)


def _pm_ok(ledger_list):
    pm = sum(int(c.pm_writes) for _, _, c in ledger_list)
    ok = sum(int(o.sum()) for _, o, _ in ledger_list)
    return pm, ok


def test_level_sweep_reaches_move_and_logged_paths():
    """At B 512 the sweep's load reaches a one-movement insert (5 PM
    writes) and logged updates (4): the totals exceed 2 per committed op."""
    _, _, led = run_sweep("level", 512, False, False, seed=1)
    pm, ok = _pm_ok(led["insert"])
    assert pm > 2 * ok and (pm - 2 * ok) % 3 == 0
    pm, ok = _pm_ok(led["update"])
    assert pm > 2 * ok and (pm - 2 * ok) % 2 == 0


def test_level_move_and_update_paths_crafted():
    """num_top 4: top 0, top 1 and bottom 0 filled by keys whose four
    candidates lie among them, except top 0's slot-0 item, whose other top
    bucket is 2.  A key with h1 = 0 and h2 in {0, 1} then takes the move
    path (5 PM writes: that item moves to top 2); an update in a full
    bucket is logged (4), one in a bucket with room goes out of place
    (2)."""
    jcfg, tcfg = jlv.LevelConfig(num_top=4), lv.LevelConfig(num_top=4)
    ids = np.arange(20_000)
    cand = np.asarray(jlv._cand_buckets(jcfg, ycsb.make_key(ids)))
    inner = ids[(cand[:, 0] < 2) & (cand[:, 1] < 2)]
    first = ids[(cand[:, 0] == 0) & (cand[:, 1] == 2)][:1]
    last = inner[11:][cand[inner[11:], 0] == 0][:1]
    order = np.concatenate([first, inner[:11], last])
    jt, tt = jlv.create(jcfg), lv.create(tcfg, "cpu")
    pms = []
    for i in range(len(order)):      # one op per batch: its own PM count
        k, v = kv(order[i:i + 1], i)
        jout = jlv.insert(jcfg, jt, k, v)
        tout = lv.insert(tcfg, tt, k, v)
        jt = jout[0]
        assert_op_equal(jout, tout)
        assert_tables_equal(jt, tt, convert.level_table_to_numpy)
        pms.append(int(tout[2].pm_writes))
    assert pms == [2] * 12 + [5]
    np.testing.assert_array_equal(tt.tkeys[2, 0].numpy().view(np.uint32),
                                  kv(first)[0][0])
    k, v = kv(order[[12, 2]], 99)    # top 0 (now full), then top 2's item
    k[1] = kv(first)[0][0]
    for i, want in enumerate((4, 2)):
        jout = jlv.update(jcfg, jt, k[i:i + 1], v[i:i + 1])
        tout = lv.update(tcfg, tt, k[i:i + 1], v[i:i + 1])
        jt = jout[0]
        assert_op_equal(jout, tout)
        assert_tables_equal(jt, tt, convert.level_table_to_numpy)
        assert int(tout[2].pm_writes) == want


@pytest.mark.parametrize("B", [64, 512])
def test_pfarm_reaches_chain_and_full_pool(B):
    cfg, t, led = run_sweep("pfarm", B, False, False, seed=2)
    assert int(t.ocount) == cfg.pool_blocks          # every block allocated
    ok = torch.cat([o for _, o, _ in led["insert"]])
    assert not bool(ok.all())                        # the pool ran out
    assert bool((t.head >= 0).any())


def _ids_with_home(home_of, want, n, start=0):
    """The first ``n`` key ids (from ``start``) whose home is ``want``."""
    ids = np.arange(start, start + 200_000)
    homes = home_of(ycsb.make_key(ids))
    return ids[homes == want][:n]


def test_pfarm_displacement_then_chain():
    """A full window whose last bucket holds items of a later home: the
    next insert displaces the first such item into its own window (bucket
    6), and once nothing can move the insert chains a block."""
    jcfg = jpf.PFarmConfig(num_buckets=16)
    tcfg = pf.PFarmConfig(num_buckets=16)

    def home_of(k):
        return np.asarray(jpf._home(jcfg, np.asarray(k)))
    ids = np.concatenate([_ids_with_home(home_of, 5, 4),
                          _ids_with_home(home_of, 0, 20 + 1 + 24)])
    jt, tt = jpf.create(jcfg), pf.create(tcfg, "cpu")
    for s, e in ((0, 24), (24, 25), (25, 49)):       # fill, displace, chain
        k, v = kv(ids[s:e], s)
        jout = jpf.insert(jcfg, jt, k, v)
        tout = pf.insert(tcfg, tt, k, v)
        jt = jout[0]
        assert_op_equal(jout, tout)
        assert_tables_equal(jt, tt, convert.pfarm_table_to_numpy)
        if e == 25:   # the displaced item sits at bucket 6, slot 0
            np.testing.assert_array_equal(
                tt.keys[6, 0].numpy().view(np.uint32), kv(ids[:1])[0][0])
    assert int(tt.ocount) >= 1 and int(tt.head[0]) >= 0


def test_pfarm_lookup_walks_the_chain():
    jcfg, tcfg = jpf.PFarmConfig(num_buckets=16), pf.PFarmConfig(16)

    def home_of(k):
        return np.asarray(jpf._home(jcfg, np.asarray(k)))
    ids = _ids_with_home(home_of, 3, 40)
    k, v = kv(ids)
    jt, _, _ = jpf.insert(jcfg, jpf.create(jcfg), k, v)
    tt, _, _ = pf.insert(tcfg, pf.create(tcfg, "cpu"), k, v)
    q = np.concatenate([k, ycsb.negative_keys(np.random.RandomState(0),
                                              200_000, 16)])
    tr = assert_reads_equal("pfarm", jpf, pf, jcfg, tcfg, jt, tt, q,
                            np.full(len(q), 9))
    assert int(tr.reads.max()) > 1 and bool(tr.where[:, 0].any())


# -- the intent of tests/test_baselines.py, through the port's API -----------

def cpu(scheme, slots):
    return api.make_store(scheme, table_slots=slots, device="cpu")


def test_level_table1_band_and_roundtrip():
    store = cpu("level", 384)                         # num_top 64
    t = store.create()
    K, V = kv(np.arange(180))
    t, r = store.insert(t, K, V)
    ok = r.ok.numpy()
    assert 2.0 <= int(r.ledger.pm_writes) / ok.sum() <= 2.2
    res = store.lookup(t, K)
    assert res.ok.numpy()[ok].all()
    np.testing.assert_array_equal(res.values.numpy()[ok].view(np.uint32),
                                  V[ok])
    V2 = kv(np.arange(180), 1)[1]
    t, u = store.update(t, K, V2)
    assert 2.0 <= u.ledger.pm_per_op() * u.ledger.ops.item() / max(
        int(u.ok.sum()), 1) <= 5.0
    got = store.lookup(t, K).values.numpy().view(np.uint32)
    np.testing.assert_array_equal(got[u.ok.numpy()], V2[u.ok.numpy()])
    t, d = store.delete(t, K[:50])
    assert int(d.ledger.pm_writes) == int(d.ok.sum())


def test_level_negative_search_reads_four_buckets():
    store = cpu("level", 384)
    t, _ = store.insert(store.create(), *kv(np.arange(100)))
    neg = ycsb.negative_keys(np.random.RandomState(2), 100, 300)
    res = store.lookup(t, neg)
    assert not bool(res.ok.any())
    assert 3.5 <= float(res.reads.float().mean()) <= 4.0
    assert int(res.ledger.rdma_reads) == int(res.reads.sum())


def test_pfarm_recipe_cost_and_single_read_window():
    store = cpu("pfarm", 320)                         # 64 buckets
    t = store.create()
    K, V = kv(np.arange(100))
    t, r = store.insert(t, K, V)
    assert int(r.ledger.pm_writes) == 5 * int(r.ok.sum())
    res = store.lookup(t, K)
    ok = r.ok.numpy()
    if int(t.ocount) == 0:
        assert int(res.reads.numpy()[ok].max()) == 1
    else:
        assert int(res.reads.numpy()[ok].max()) <= 1 + store.cfg.max_chain
    t, u = store.update(t, K, kv(np.arange(100), 1)[1])
    assert int(u.ledger.pm_writes) == 5 * int(u.ok.sum())
    t, d = store.delete(t, K[:30])
    assert int(d.ledger.pm_writes) == 5 * int(d.ok.sum())
    assert not bool(store.lookup(t, K[:30]).ok[d.ok].any())


@pytest.mark.parametrize("elem", [1, 16])
def test_latency_chase_reads_element_starts_each_feeding_the_next(elem):
    """The walk's latency chase (its plain version on the CPU) depends on
    the first byte of the elements it visits and on nothing else, and a
    chain of no loads returns its seed."""
    rng = np.random.RandomState(elem)
    data = rng.randint(0, 256, 4096 * elem).astype(np.uint8)
    h = scan_walk.chase(torch.from_numpy(data), elem, 2000, 0x9E3779B9)
    assert h.dtype == torch.int32 and h.shape == (1,)
    if elem > 1:
        rest = data.copy()
        rest[np.arange(len(data)) % elem != 0] ^= 0xFF
        assert torch.equal(scan_walk.chase(torch.from_numpy(rest), elem,
                                           2000, 0x9E3779B9), h)
    starts = data.copy()
    starts[::elem] ^= 0x5A
    assert not torch.equal(scan_walk.chase(torch.from_numpy(starts), elem,
                                           2000, 0x9E3779B9), h)
    assert int(scan_walk.chase(torch.from_numpy(data), elem, 0, 77)) == 77


@pytest.mark.parametrize("scheme", ["level", "pfarm", "dense"])
def test_delete_then_lookup_misses(scheme):
    store = cpu(scheme, 320)
    K, V = kv(np.arange(60))
    t, _ = store.insert(store.create(), K, V)
    t, d = store.delete(t, K[:30])
    assert bool(d.ok.all())
    assert not bool(store.lookup(t, K[:30]).ok.any())
    assert bool(store.lookup(t, K[30:]).ok.all())
    assert int(t.count) == 30


def test_dense_insert_takes_the_free_slots_in_order():
    store = cpu("dense", 16)
    K, V = kv(np.arange(16))
    t, _ = store.insert(store.create(), K[:10], V[:10])
    t, _ = store.delete(t, K[[1, 4, 7]])
    t, r = store.insert(t, K[10:16], V[10:16],
                        mask=np.array([1, 0, 1, 1, 1, 1], bool))
    # ranks 0..4 of the active ops take free slots 1, 4, 7, 10, 11
    live = np.flatnonzero(t.live.numpy())
    assert list(store.lookup(t, K[[10, 12, 13, 14, 15]]).values.numpy()
                .view(np.uint32)[:, 0]) == list(V[[10, 12, 13, 14, 15], 0])
    assert list(dn.lookup(store.cfg, t, K[[10, 12, 13, 14, 15]]).slot) == \
        [1, 4, 7, 10, 11]
    assert len(live) == 12 and r.ok.tolist() == [True, False, True, True,
                                                 True, True]


# -- the stores behind the protocol -------------------------------------------

@pytest.mark.parametrize("slots", [320, 1000, 4097])
@pytest.mark.parametrize("scheme", ["level", "pfarm", "dense"])
def test_stores_match_reference_stores(scheme, slots):
    """Same batches through both registries' stores: equal configs (the
    reference's ``from_slots`` sizing), tables, results, ledgers, stamps,
    plans, extracted items and stats."""
    from repro import api as japi
    to_numpy = MODS[scheme][2]
    js = japi.make_store(scheme, table_slots=slots)
    ts = api.make_store(scheme, table_slots=slots, device="cpu")
    assert dataclasses.asdict(js.cfg) == dataclasses.asdict(ts.cfg)
    rng = np.random.RandomState(slots)
    n = int(slots * 0.8)
    K, V = kv(np.arange(n), 1)
    V2 = kv(np.arange(n), 2)[1]
    jt, tt = js.create(), ts.create()
    for op, args in (("insert", (K, V)), ("update", (K[::3], V2[::3])),
                     ("delete", (K[1::4],))):
        jt, jr = getattr(js, op)(jt, *args)
        tt, tr = getattr(ts, op)(tt, *args)
        np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))
        assert [int(x) for x in tr.ledger] == [int(x) for x in jr.ledger]
    assert_tables_equal(jt, tt, to_numpy)
    q = np.concatenate([K, ycsb.negative_keys(rng, n, 64)])
    jr, tr = js.lookup(jt, q), ts.lookup(tt, q)
    for name in ("ok", "values", "reads"):
        same_words(getattr(jr, name), getattr(tr, name))
    assert [int(x) for x in tr.ledger] == [int(x) for x in jr.ledger]
    spans = ycsb.scan_lengths(rng, len(q))
    for jp, tp in ((jr.plan, tr.plan),
                   (js.version_read_plan(jt, q), ts.version_read_plan(tt, q)),
                   (js.scan_plan(jt, q, spans), ts.scan_plan(tt, q, spans))):
        for a, b in zip(jp, tp):
            same_words(a, b)
    same_words(js.version_stamp(jt, q), ts.version_stamp(tt, q))
    for a, b in zip(js._extract(jt), ts._extract(tt)):
        same_words(a, b)
    same_words(js.load_factor(jt), ts.load_factor(tt))
    assert js.stats(jt) == ts.stats(tt)


@pytest.mark.parametrize("scheme", ["level", "pfarm", "dense"])
def test_cuda_is_the_default_device_and_never_falls_back(scheme):
    store = api.make_store(scheme, table_slots=320)
    assert store.device == "cuda" and isinstance(store, api.HashStore)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only rule cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.create()
    from_np = getattr(convert, f"{scheme}_table_from_numpy")
    fields = MODS[scheme][2](api.make_store(scheme, table_slots=320,
                                            device="cpu").create())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_np(fields, "cuda")


@pytest.mark.parametrize("method,item", [
    ("begin_resize", "item 5"), ("resize_step", "item 5"),
    ("resize_cutover", "item 5"), ("resize", "item 5"),
    ("trace_insert", "item 8"), ("trace_update", "item 8"),
    ("trace_delete", "item 8"), ("recover", "item 8")])
def test_unported_surfaces_name_their_roadmap_item(method, item):
    for scheme in api.available_schemes():
        store = api.make_store(scheme, table_slots=320, device="cpu")
        args = {"begin_resize": (None,), "resize_step": (None,),
                "resize_cutover": (None,), "resize": (None,),
                "trace_insert": (None, None, None),
                "trace_update": (None, None, None),
                "trace_delete": (None, None), "recover": (None,)}[method]
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            getattr(store, method)(*args)
