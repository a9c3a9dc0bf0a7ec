"""The PyTorch port's continuity table against the JAX package, on the CPU.

The same numpy-seeded batches go through ``repro.core.continuity`` (JAX on
the CPU) and ``repro_torch.core.continuity`` (``device="cpu"``).  Every
``ContinuityTable`` field must be byte-equal after each insert, with stash
off and on, duplicate keys and masks; lookups on tables the JAX package
built, verb plans and ledgers must match exactly.  Update and delete are
in ``test_torch_mutation.py``, which shares the helpers below.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.core.continuity as ch
from repro.data import ycsb
from repro.kernels import ops as JK
from repro.rdma import verbs as jrv
import repro_torch.core.continuity as tch
from repro_torch.convert import table_from_numpy, table_to_numpy
from repro_torch.kernels import ops as TK
from repro_torch.rdma import verbs as trv


def cfgs(**kw):
    return ch.ContinuityConfig(**kw), tch.ContinuityConfig(**kw)


def np_fields(t) -> dict:
    return {f: np.asarray(getattr(t, f)) for f in t._fields}


def assert_tables_equal(jt, tt):
    want, got = np_fields(jt), table_to_numpy(tt)
    bad = [f for f in want if want[f].dtype != got[f].dtype
           or not np.array_equal(want[f], got[f])]
    assert not bad, f"fields differ: {bad}"


def as_np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(want, got):
    """Exact equality of a reference output and the port's; the port's
    int32 words are read as uint32 where the reference's array is."""
    w, g = as_np(want), as_np(got)
    if w.dtype == np.uint32:
        g = g.astype(np.int64).astype(np.uint32)
    assert w.shape == g.shape, (w.shape, g.shape)
    np.testing.assert_array_equal(g, w)


def assert_ledgers_equal(jc, tc):
    for name, a, b in zip(jc._fields, jc, tc):
        assert int(a) == int(b), name


def keys_vals(ids, seed=0):
    rng = np.random.RandomState(seed)
    ids = np.asarray(ids)
    return ycsb.make_key(ids), ycsb.make_value(rng, len(ids))


def mixed_ids(batch, rng, start=0):
    """Live keys, absent keys and duplicates (1/8 of the batch)."""
    ids = np.arange(start, start + batch)
    ids[batch - batch // 8:] = start + rng.randint(0, batch // 2,
                                                   size=batch // 8)
    return ids


class SetScatterCheck(TorchDispatchMode):
    """Fails a set-scatter (``index_put`` without accumulate) that writes
    DIFFERENT values to one location: its result would depend on the
    order the card applies the writes in.  Counts the scatters seen."""

    def __init__(self):
        super().__init__()
        self.calls = 0
        self.conflicts = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.ops.aten.index_put_.default,
                    torch.ops.aten.index_put.default):
            acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
            if not acc:
                self._check(func, *args[:3])
        return func(*args, **kwargs)

    def _check(self, func, dst, indices, values):
        self.calls += 1
        idx = []
        for i in indices:
            assert i is not None, "scatter over a non-leading dimension"
            if i.dtype == torch.bool:
                idx.extend(i.nonzero().unbind(1))
            else:
                idx.append(i)
        idx = [a.numpy() for a in torch.broadcast_tensors(*idx)]
        lead = dst.shape[:len(idx)]
        lin = np.ravel_multi_index([a.reshape(-1) for a in idx], lead)
        if not len(lin):
            return
        vals = np.broadcast_to(values.numpy(), idx[0].shape
                               + tuple(dst.shape[len(idx):]))
        vals = vals.reshape(len(lin), -1)
        _, first, inv = np.unique(lin, return_index=True, return_inverse=True)
        if not np.array_equal(vals, vals[first][inv]):
            self.conflicts.append((str(func), tuple(dst.shape)))


# ---------------------------------------------------------------------------
# insert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stash", [0.0, 1 / 8], ids=["nostash", "stash"])
@pytest.mark.parametrize("batch", [64, 512])
def test_insert_matches_reference(batch, stash):
    jcfg, tcfg = cfgs(num_buckets=max(32, batch // 4), stash_frac=stash)
    rng = np.random.RandomState(batch)
    K, V = keys_vals(mixed_ids(batch, rng))
    mask = rng.rand(batch) > 0.1
    jt, jok, jc = ch.insert(jcfg, ch.create(jcfg), K, V, jnp.asarray(mask))
    tt = tch.create(tcfg, "cpu")
    tt2, tok, tc = tch.insert(tcfg, tt, K, V, mask)
    assert tt2 is tt                              # updated in place
    assert_tables_equal(jt, tt)
    assert_same(jok, tok)
    assert_ledgers_equal(jc, tc)


def _contended_ids(cfg, pair, n):
    even, odd = [], []
    i = 0
    while len(even) < n or len(odd) < n:
        p, par = ch.locate(cfg, jnp.asarray(ycsb.make_key(np.array([i]))))
        if int(p[0]) == pair:
            (even if int(par[0]) == 0 else odd).append(i)
        i += 1
    inter = np.empty(2 * n, np.int64)
    inter[0::2], inter[1::2] = even[:n], odd[:n]
    return inter


# geometries where the fused insert must leave its fast path: extension
# groups granted mid-batch, both parities of a pair contending for the
# shared SBuckets (residual wave loop), and a main table overflowing into
# the stash
OVERFLOW_CASES = {
    "ext_grants": (dict(num_buckets=8, ext_frac=1.0), np.arange(180)),
    "parity_contention": (dict(num_buckets=4, ext_frac=0.5), None),
    "stash_overflow": (dict(num_buckets=4, stash_frac=1 / 8),
                       np.arange(90)),
}


@pytest.mark.parametrize("case", sorted(OVERFLOW_CASES))
def test_insert_overflow_paths_match_reference(case):
    kw, ids = OVERFLOW_CASES[case]
    jcfg, tcfg = cfgs(**kw)
    if ids is None:
        ids = _contended_ids(jcfg, pair=1, n=16)
    K, V = keys_vals(ids)
    jt, jok, jc = ch.insert(jcfg, ch.create(jcfg), K, V)
    tt, tok, tc = tch.insert(tcfg, tch.create(tcfg, "cpu"), K, V)
    assert_tables_equal(jt, tt)
    assert_same(jok, tok)
    assert_ledgers_equal(jc, tc)
    if case == "ext_grants":
        assert int(tt.ext_count) >= 1
    if case == "stash_overflow":
        assert int((tt.stash_meta != 0).sum()) > 0


# ---------------------------------------------------------------------------
# read path, plans, helpers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _loaded(stash):
    """A JAX-built table with extension groups (and stash entries)."""
    kw = dict(num_buckets=8, ext_frac=1.0, stash_frac=stash)
    jcfg = ch.ContinuityConfig(**kw)
    K, V = keys_vals(np.arange(170))
    jt, _, _ = ch.insert(jcfg, ch.create(jcfg), K, V)
    q = np.concatenate([K, ycsb.negative_keys(np.random.RandomState(4),
                                              170, 40)])
    return kw, jt, q


@pytest.mark.parametrize("stash", [0.0, 1 / 8], ids=["nostash", "stash"])
def test_lookup_and_probe_lookup_match_reference(stash):
    kw, jt, q = _loaded(stash)
    jcfg, tcfg = ch.ContinuityConfig(**kw), tch.ContinuityConfig(**kw)
    tt = table_from_numpy(np_fields(jt), "cpu")
    want = ch.lookup(jcfg, jt, q)
    assert int(np.asarray(want.reads).max()) >= 2       # ext tail exercised
    got = [tch.lookup(tcfg, tt, q)]
    for use_kernel in (True, False):
        for use_fp in (True, False):
            got.append(TK.probe_lookup(tcfg, tt, q, use_kernel=use_kernel,
                                       use_fp=use_fp))
    jk = JK.probe_lookup(jcfg, jt, q, use_kernel=False)
    for res in got:
        for name, w, g, k in zip(want._fields, want, res, jk):
            assert_same(w, g)
            assert_same(k, g)


@pytest.mark.parametrize("stash", [0.0, 1 / 8], ids=["nostash", "stash"])
def test_plans_stamps_and_ledger_match_reference(stash):
    kw, jt, q = _loaded(stash)
    jcfg, tcfg = ch.ContinuityConfig(**kw), tch.ContinuityConfig(**kw)
    tt = table_from_numpy(np_fields(jt), "cpu")
    jres, tres = ch.lookup(jcfg, jt, q), tch.lookup(tcfg, tt, q)
    jp = ch.lookup_plan(jcfg, jt, q, jres)
    tp = tch.lookup_plan(tcfg, tt, q, tres)
    for a, b in zip(jp, tp):
        assert_same(a, b if b.dtype != torch.int64 else b.to(torch.int32))
    assert_ledgers_equal(jrv.ledger_from_plan(jp), trv.ledger_from_plan(tp))
    assert_same(jrv.reads_per_op(jp), trv.reads_per_op(tp))
    assert int(jrv.round_trips(jp)) == int(trv.round_trips(tp))
    flat = trv.flatten(trv.VerbPlan(*(x.reshape(1, *x.shape) for x in tp)))
    assert all(torch.equal(a, b) for a, b in zip(flat, tp))
    for a, b in zip(ch.version_read_plan(jcfg, jt, q),
                    tch.version_read_plan(tcfg, tt, q)):
        assert_same(a, b if b.dtype != torch.int64 else b.to(torch.int32))
    assert_same(ch.version_stamp(jcfg, jt, q), tch.version_stamp(tcfg, tt, q))
    pairs = np.arange(jcfg.num_pairs)
    assert_same(ch.stash_count(jt, jnp.asarray(pairs)),
                tch.stash_count(tt, torch.from_numpy(pairs)))
    assert_same(ch.load_factor(jcfg, jt), tch.load_factor(tcfg, tt))
    assert_same(ch.capacity(jcfg, jt), tch.capacity(tcfg, tt))


def test_probe_table_mutation_plan_and_fp_stats_match_reference():
    kw, jt, q = _loaded(1 / 8)
    jcfg, tcfg = ch.ContinuityConfig(**kw), tch.ContinuityConfig(**kw)
    tt = table_from_numpy(np_fields(jt), "cpu")
    for use_fp in (False, True):
        for a, b in zip(JK.probe_table(jcfg, jt, q, use_kernel=False,
                                       use_fp=use_fp),
                        TK.probe_table(tcfg, tt, q, use_fp=use_fp)):
            assert_same(a, b)
    for a, b in zip(JK.mutation_plan(jcfg, jt, q, use_kernel=False),
                    TK.mutation_plan(tcfg, tt, q)):
        assert_same(a, b)
    miss = ycsb.negative_keys(np.random.RandomState(8), 170, 400)
    assert JK.fp_filter_stats(jcfg, jt, miss) == \
        TK.fp_filter_stats(tcfg, tt, miss)
    assert np.array_equal(JK.priority_table(jcfg), TK.priority_table(tcfg))


def test_word_helpers_match_reference():
    rng = np.random.RandomState(2)
    w = rng.randint(0, 2 ** 32, size=512, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 0xFFFFFFFF, 1 << 31, 0xFFFFF]
    par = rng.randint(0, 2, size=512)
    tw = torch.from_numpy(w.astype(np.int64))
    jcfg, tcfg = cfgs(num_buckets=64)
    assert_same(ch._bitreverse32(jnp.asarray(w)), tch._bitreverse32(tw))
    canon_j = ch._canonical_occupancy(jcfg, jnp.asarray(w), jnp.asarray(par))
    canon_t = tch._canonical_occupancy(tcfg, tw, torch.from_numpy(par))
    assert_same(canon_j, canon_t)
    empty = ~np.asarray(canon_j) & np.uint32((1 << 28) - 1)
    n = rng.randint(0, 29, size=512)
    valid = n < np.array([bin(int(x)).count("1") for x in empty])
    sel_j = np.asarray(ch._select_bit(jnp.asarray(empty), jnp.asarray(n)))
    sel_t = tch._select_bit(torch.from_numpy(empty.astype(np.int64)),
                            torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(sel_t[valid], sel_j[valid])
    K = ycsb.make_key(np.arange(300))
    tk = torch.from_numpy(K.view(np.int32))
    for a, b in zip(ch.locate(jcfg, jnp.asarray(K)), tch.locate(tcfg, tk)):
        assert_same(a, b)
    assert_same(ch.fingerprint(jnp.asarray(K)), tch.fingerprint(tk))
    assert np.array_equal(ch._probe_order(jcfg), tch._probe_order(tcfg))
    ids = np.concatenate([np.zeros(5, np.int64), np.arange(1, 40)])
    act = np.concatenate([np.ones(5, bool), np.zeros(39, bool)])
    jw = ch._plan_waves(jcfg, jnp.asarray(ycsb.make_key(ids)),
                        jnp.asarray(act))
    tw_ = tch._plan_waves(tcfg, torch.from_numpy(ycsb.make_key(ids)
                                                 .view(np.int32)),
                          torch.from_numpy(act))
    for a, b in zip(jw[:3], tw_[:3]):
        assert_same(a, b)
    assert int(jw[3]) == tw_[3] == 5


def test_convert_round_trip_and_checks():
    _, jt, _ = _loaded(1 / 8)
    fields = np_fields(jt)
    tt = table_from_numpy(fields, "cpu")
    assert all(t.dtype == torch.int32 for t in tt)
    back = table_to_numpy(tt)
    for f in fields:
        assert back[f].dtype == fields[f].dtype
        np.testing.assert_array_equal(back[f], fields[f])
    with pytest.raises(ValueError, match="missing"):
        table_from_numpy({k: v for k, v in fields.items() if k != "fp"},
                         "cpu")
    with pytest.raises(ValueError, match="must be uint32"):
        table_from_numpy({**fields, "keys": fields["keys"].astype(np.int64)},
                         "cpu")
