"""The PyTorch port's fused update and delete against the JAX package, on
the CPU, through every match backend (``gather``, ``reference`` and
``kernel``: on the CPU the kernel wrapper runs its plain version).

Every ``ContinuityTable`` field must be byte-equal after each batch, with
stash off and on, duplicate keys and masks; the port updates tables in
place, so each case loads the JAX pre-state into a fresh port table.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.continuity as ch
import repro_torch.core.continuity as tch
from repro_torch.convert import table_from_numpy
from test_torch_continuity import (SetScatterCheck, _contended_ids,
                                   assert_ledgers_equal, assert_same,
                                   assert_tables_equal, cfgs, keys_vals,
                                   mixed_ids, np_fields)


# ---------------------------------------------------------------------------
# update / delete, every match backend
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mutation_case(op, batch, stash):
    """(cfg kwargs, pre-table fields, keys, vals, mask, JAX post-state)."""
    kw = dict(num_buckets=max(32, batch // 4), stash_frac=stash)
    jcfg = ch.ContinuityConfig(**kw)
    rng = np.random.RandomState(batch + int(stash * 8))
    kb, vb = keys_vals(np.arange(3 * batch // 4))
    jt, _, _ = ch.insert(jcfg, ch.create(jcfg), kb, vb)
    K, V = keys_vals(mixed_ids(batch, rng), seed=1)
    mask = rng.rand(batch) > 0.1
    if op == "update":
        post = ch.update(jcfg, jt, K, V, jnp.asarray(mask))
    else:
        post = ch.delete(jcfg, jt, K, jnp.asarray(mask))
    return kw, np_fields(jt), K, V, mask, post


@pytest.mark.parametrize("probe", ["gather", "reference", "kernel"])
@pytest.mark.parametrize("stash", [0.0, 1 / 8], ids=["nostash", "stash"])
@pytest.mark.parametrize("batch", [64, 512])
@pytest.mark.parametrize("op", ["update", "delete"])
def test_mutation_matches_reference(op, batch, stash, probe):
    kw, pre, K, V, mask, (jt, jok, jc) = _mutation_case(op, batch, stash)
    tcfg = tch.ContinuityConfig(**kw)
    tt = table_from_numpy(pre, "cpu")
    if op == "update":
        tt2, tok, tc = tch.update(tcfg, tt, K, V, mask, probe=probe)
    else:
        tt2, tok, tc = tch.delete(tcfg, tt, K, mask, probe=probe)
    assert tt2 is tt
    assert_tables_equal(jt, tt)
    assert_same(jok, tok)
    assert_ledgers_equal(jc, tc)
    assert int(tok.sum()) > 0


@pytest.mark.parametrize("probe", ["gather", "kernel"])
def test_mutations_on_stash_and_extension_hits(probe):
    """A tiny overflowed table, so updates relocate stash entries and both
    ops hit extension slots, with duplicate keys in the batch."""
    jcfg, tcfg = cfgs(num_buckets=4, ext_frac=0.5, stash_frac=1 / 8)
    K, V = keys_vals(np.arange(110))
    jt, _, _ = ch.insert(jcfg, ch.create(jcfg), K, V)
    assert int(jt.ext_count) > 0
    assert int((np.asarray(jt.stash_meta) != 0).sum()) > 0
    ids = np.concatenate([np.arange(110), [3, 3, 50, 101]])
    K2, V2 = keys_vals(ids, seed=9)
    ju, juok, juc = ch.update(jcfg, jt, K2, V2)
    tt = table_from_numpy(np_fields(jt), "cpu")
    _, tok, tc = tch.update(tcfg, tt, K2, V2, probe=probe)
    assert_tables_equal(ju, tt)
    assert_same(juok, tok)
    assert_ledgers_equal(juc, tc)
    jd, jdok, jdc = ch.delete(jcfg, ju, K2)
    _, tok, tc = tch.delete(tcfg, tt, K2, probe=probe)
    assert_tables_equal(jd, tt)
    assert_same(jdok, tok)
    assert_ledgers_equal(jdc, tc)


def test_set_scatters_never_conflict():
    """The engine's set-scatters write one value per location (what makes
    them deterministic on the card), through every write path: fused and
    residual waves, extension grants and the pool relabel, stash
    fallback, relocation and release."""
    jcfg, tcfg = cfgs(num_buckets=4, ext_frac=0.5, stash_frac=1 / 8)
    ids = np.concatenate([_contended_ids(jcfg, pair=1, n=12),
                          np.arange(100, 160), [100, 100, 101]])
    K, V = keys_vals(ids)
    K2, V2 = keys_vals(np.concatenate([ids[::-1], ids[:7]]), seed=3)
    tt = tch.create(tcfg, "cpu")
    with SetScatterCheck() as mode:
        tch.insert(tcfg, tt, K, V)
        for probe in ("gather", "kernel"):
            tch.update(tcfg, tt, K2, V2, probe=probe)
        tch.delete(tcfg, tt, K2[::2], probe="kernel")
        tch.delete(tcfg, tt, K2, probe="gather")
    assert mode.calls > 0
    assert not mode.conflicts, mode.conflicts
    assert int(tt.count) == 0
