"""The port's serial oracles (``insert_serial`` / ``update_serial`` /
``delete_serial``) against the JAX package's and against the port's own
wave engine, on the CPU.

Every ``ContinuityTable`` field must be byte-equal, with ``ok`` and the
ledger, over the sweep of ``tests/test_wave_engine.py`` and
``tests/test_mutation_fused.py``: B 64 / 512, stash off and 1/8, distinct
keys or duplicates with a mask.  The tables are small enough that inserts
spill into extension groups and, with a stash, into the stash, and the
update and delete batches start from a table loaded that far.  That sweep
gives the pool a group for every pair (``ext_frac`` 1.0).  Where the pool
runs out inside a batch, the reference's own wave engine and serial
oracle grant groups in different orders (ROADMAP.md Queue 3), so no
engine can equal both: at ``ext_frac`` 0.1 and 0.5 (the reference fuzz's
other draws) the port's serial oracle is held against the reference's
serial oracle and the port's wave engine against the reference's wave
engine, each on its own.  The port updates tables in place, so each side
starts from a fresh copy of the JAX pre-state.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.continuity as ch
import repro_torch.core.continuity as tch
from repro_torch import api
from repro_torch.convert import table_from_numpy
from test_torch_continuity import (assert_ledgers_equal, assert_same,
                                   assert_tables_equal, keys_vals, mixed_ids,
                                   np_fields)

OPS = ("insert", "update", "delete")
SERIAL = {"insert": ch.insert_serial, "update": ch.update_serial,
          "delete": ch.delete_serial}


def _run(mod, op, cfg, table, K, V, mask, serial=True):
    fn = getattr(mod, f"{op}_serial" if serial else op)
    return (fn(cfg, table, K, mask) if op == "delete"
            else fn(cfg, table, K, V, mask))


@functools.lru_cache(maxsize=None)
def _pre(op, batch, stash, ext_frac):
    """(cfg kwargs, JAX pre-table, its base size) of one sweep case."""
    kw = dict(num_buckets=batch // 16, stash_frac=stash, ext_frac=ext_frac)
    jcfg = ch.ContinuityConfig(**kw)
    n_base = 3 * batch // 8 if op == "insert" else 7 * batch // 8
    kb, vb = keys_vals(np.arange(n_base))
    jt, _, _ = ch.insert(jcfg, ch.create(jcfg), kb, vb)
    return kw, jt, n_base


@functools.lru_cache(maxsize=None)
def _case(op, batch, stash, variant, ext_frac=1.0):
    """(cfg kwargs, pre-table fields, keys, vals, mask, JAX serial
    post-state)."""
    kw, jt, n_base = _pre(op, batch, stash, ext_frac)
    jcfg = ch.ContinuityConfig(**kw)
    rng = np.random.RandomState(batch + int(stash * 8) + len(variant))
    start = n_base - batch // 8 if op == "insert" else 0
    if variant == "distinct":
        ids = np.arange(start, start + batch)
        mask = np.ones(batch, bool)
    else:
        ids = mixed_ids(batch, rng, start)
        mask = rng.rand(batch) > 0.1
    K, V = keys_vals(ids, seed=1)
    post = _run(ch, op, jcfg, jt, K, V, jnp.asarray(mask))
    return kw, np_fields(jt), K, V, mask, post


@pytest.mark.parametrize("variant", ["distinct", "dups_masked"])
@pytest.mark.parametrize("stash", [0.0, 1 / 8], ids=["nostash", "stash"])
@pytest.mark.parametrize("batch", [64, 512])
@pytest.mark.parametrize("op", OPS)
def test_serial_matches_reference_and_wave_engine(op, batch, stash,
                                                  variant):
    kw, pre, K, V, mask, (jt, jok, jc) = _case(op, batch, stash, variant)
    tcfg = tch.ContinuityConfig(**kw)
    tt = table_from_numpy(pre, "cpu")
    tt2, tok, tc = _run(tch, op, tcfg, tt, K, V, mask)
    assert tt2 is tt
    assert_tables_equal(jt, tt)
    assert_same(jok, tok)
    assert_ledgers_equal(jc, tc)
    assert int(tok.sum()) > 0
    # the port's wave engine lands on the same bytes
    tw = table_from_numpy(pre, "cpu")
    _, wok, wc = _run(tch, op, tcfg, tw, K, V, mask, serial=False)
    assert_tables_equal(jt, tw)
    assert_same(jok, wok)
    assert_ledgers_equal(jc, wc)


@pytest.mark.parametrize("stash", [0.0, 1 / 8], ids=["nostash", "stash"])
@pytest.mark.parametrize("batch", [64, 512])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("ext_frac", [0.1, 0.5])
def test_short_pool_each_engine_matches_its_reference(ext_frac, op, batch,
                                                      stash):
    """A pool short of a group per pair: port serial == reference serial
    and port wave == reference wave, every field, ``ok`` and the ledger.
    Serial == wave is not asserted: where the pool runs out mid-batch the
    two references differ."""
    kw, pre, K, V, mask, (jt, jok, jc) = _case(op, batch, stash,
                                               "dups_masked", ext_frac)
    tcfg = tch.ContinuityConfig(**kw)
    tt = table_from_numpy(pre, "cpu")
    _, tok, tc = _run(tch, op, tcfg, tt, K, V, mask)
    assert_tables_equal(jt, tt)
    assert_same(jok, tok)
    assert_ledgers_equal(jc, tc)
    assert int(tok.sum()) > 0
    _, jpre, _ = _pre(op, batch, stash, ext_frac)
    jw, jwok, jwc = _run(ch, op, ch.ContinuityConfig(**kw), jpre, K, V,
                         jnp.asarray(mask), serial=False)
    tw = table_from_numpy(pre, "cpu")
    _, wok, wc = _run(tch, op, tcfg, tw, K, V, mask, serial=False)
    assert_tables_equal(jw, tw)
    assert_same(jwok, wok)
    assert_ledgers_equal(jwc, wc)


def test_pool_running_out_mid_batch_reproduces_each_engine():
    """ROADMAP.md Queue 3's example: a 4-bucket table with ``ext_frac``
    0.1 (one pool group), records 200-223 loaded, then 224-287 inserted.
    The reference's serial oracle grants the one group to pair 0, its wave
    engine to pair 1; the port reproduces each side byte for byte."""
    kw = dict(num_buckets=4, stash_frac=0.0, ext_frac=0.1)
    jcfg, tcfg = ch.ContinuityConfig(**kw), tch.ContinuityConfig(**kw)
    kb, vb = keys_vals(np.arange(200, 224))
    jt, _, _ = ch.insert(jcfg, ch.create(jcfg), kb, vb)
    K, V = keys_vals(np.arange(224, 288), seed=1)
    mask = np.ones(64, bool)
    out = {}
    for serial in (True, False):
        want = _run(ch, "insert", jcfg, jt, K, V, jnp.asarray(mask), serial)
        tt = table_from_numpy(np_fields(jt), "cpu")
        _, tok, tc = _run(tch, "insert", tcfg, tt, K, V, mask, serial)
        assert_tables_equal(want[0], tt)
        assert_same(want[1], tok)
        assert_ledgers_equal(want[2], tc)
        out[serial] = np.asarray(want[0].ext_map)
    assert int(jcfg.ext_pool_pairs) == 1
    assert out[True].tolist() == [0, -1] and out[False].tolist() == [-1, 0]


@pytest.mark.parametrize("op", OPS)
def test_sweep_engages_extension_and_stash(op):
    """The stash cases really reach the extension pool and the stash: the
    inserts spill there, and the deletes and updates start from a table
    with live stash entries."""
    _, pre, *_, (jt, _, _) = _case(op, 512, 1 / 8, "dups_masked")
    stashed = int((np.asarray(jt.stash_meta) != 0).sum())
    assert int(jt.ext_count) > 0
    if op == "insert":
        assert stashed > 0
    else:
        assert int((pre["stash_meta"] != 0).sum()) > 0


@pytest.mark.parametrize("op", OPS)
def test_serial_policy_runs_the_oracles(op):
    """``ExecPolicy(engine="serial")`` routes a continuity store's writes
    through the serial oracles, byte-equal to the default engine."""
    rng = np.random.RandomState(5)
    K, V = keys_vals(np.arange(200), seed=2)
    ids = np.concatenate([np.arange(40, 140), [41, 41, 77]])
    K2, V2 = keys_vals(ids, seed=3)
    mask = rng.rand(len(ids)) > 0.2
    out = {}
    for engine in ("serial", "wave"):
        store = api.make_store("continuity", table_slots=240,
                               policy=api.ExecPolicy(engine=engine),
                               device="cpu")
        t, _ = store.insert(store.create(), K, V)
        if op == "insert":
            t, res = store.insert(t, K2, V2, mask)
        elif op == "update":
            t, res = store.update(t, K2, V2, mask)
        else:
            t, res = store.delete(t, K2, mask)
        out[engine] = (t, res)
    (ts, rs), (tw, rw) = out["serial"], out["wave"]
    for f in ts._fields:
        assert np.array_equal(getattr(ts, f).numpy(),
                              getattr(tw, f).numpy()), f
    assert np.array_equal(rs.ok.numpy(), rw.ok.numpy())
    assert_ledgers_equal(rs.ledger, rw.ledger)
