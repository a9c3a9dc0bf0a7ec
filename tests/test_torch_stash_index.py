"""The stash index of the port's continuity store (`_stash_find`) against
its dense plain version and the JAX package, on the CPU.

Stash-heavy tables (32 and 256 buckets filled past load 0.9, stash 1/8)
built by the reference, with entries deleted and a live entry repeated at
a higher index: the index gives the dense compare's hit and lowest stash
index for live, deleted, absent and repeated keys; lookup, update and
delete through every match backend stay byte-equal to the reference with
masks and duplicate keys; and one lookup over a stash of 2**22+ slots
(where the dense compare would need over 200 GB) runs on the CPU without
any (B, T) tensor.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.core.continuity as ch
import repro_torch.core.continuity as tch
from repro_torch.convert import table_from_numpy
from test_torch_continuity import (assert_ledgers_equal, assert_same,
                                   assert_tables_equal, cfgs, keys_vals,
                                   np_fields)


@functools.lru_cache(maxsize=None)
def _heavy(num_buckets):
    """(cfg kwargs, table fields, ids loaded): the reference's table past
    load 0.9 with a 1/8 stash, a tenth of the keys deleted, and one live
    stash entry repeated at a higher free index."""
    kw = dict(num_buckets=num_buckets, stash_frac=1 / 8)
    jcfg = ch.ContinuityConfig(**kw)
    n = int(jcfg.num_pairs * jcfg.slots_per_pair * 1.02)
    K, V = keys_vals(np.arange(n))
    jt, ok, _ = ch.insert(jcfg, ch.create(jcfg), K, V)
    rng = np.random.RandomState(num_buckets)
    gone = rng.choice(n, n // 10, replace=False)
    jt, _, _ = ch.delete(jcfg, jt, K[gone])
    f = {k: v.copy() for k, v in np_fields(jt).items()}
    live = np.flatnonzero(f["stash_meta"])
    free = np.flatnonzero(f["stash_meta"] == 0)
    assert len(live) > 4 and len(free) > 0
    assert int(jt.count) / (jcfg.num_pairs * jcfg.slots_per_pair) >= 0.9
    src, dst = live[1], free[-1]
    assert dst > src
    for field in ("stash_keys", "stash_vals", "stash_meta"):
        f[field][dst] = f[field][src]
    return kw, f, n


def _queries(n, rng):
    ids = rng.randint(0, n + n // 4, size=512)      # live, deleted, absent
    return np.concatenate([ids, ids[:32]])           # and repeated


@pytest.mark.parametrize("num_buckets", [32, 256])
def test_stash_find_equals_dense_and_reference(num_buckets):
    kw, f, n = _heavy(num_buckets)
    jcfg, tcfg = cfgs(**kw)
    tt = table_from_numpy(f, "cpu")
    K, _ = keys_vals(_queries(n, np.random.RandomState(1)))
    first = np.flatnonzero(f["stash_meta"])[1]
    K = np.concatenate([K, f["stash_keys"][first][None]])  # the repeated
    kt = torch.from_numpy(K.view(np.int32))
    pair, _ = tch.locate(tcfg, kt)
    hit, sidx = tch._stash_find(tcfg, tt, kt, pair)
    dhit, dsidx = tch._stash_find_dense(tcfg, tt, kt, pair)
    assert torch.equal(hit, dhit) and torch.equal(sidx, dsidx)
    jt = ch.ContinuityTable(**{k: jnp.asarray(v) for k, v in f.items()})
    jm = ch._stash_match(jcfg, jt, jnp.asarray(K), jnp.asarray(pair.numpy()))
    assert_same(np.asarray(jm).any(-1), hit)
    assert_same(np.asarray(jm).argmax(-1).astype(np.int64), sidx)
    assert 0 < int(hit.sum()) < len(K)
    assert bool(hit[-1]) and int(sidx[-1]) == first  # the lower index


@pytest.mark.parametrize("num_buckets", [32, 256])
def test_lookup_on_stash_heavy_tables_matches_reference(num_buckets):
    kw, f, n = _heavy(num_buckets)
    jcfg, tcfg = cfgs(**kw)
    jt = ch.ContinuityTable(**{k: jnp.asarray(v) for k, v in f.items()})
    tt = table_from_numpy(f, "cpu")
    K, _ = keys_vals(_queries(n, np.random.RandomState(2)))
    want = ch.lookup(jcfg, jt, K)
    got = tch.lookup(tcfg, tt, K)
    for name in want._fields:
        assert_same(getattr(want, name), getattr(got, name))
    assert (np.asarray(want.slot) >= jcfg.total_bits).any()   # stash hits


@pytest.mark.parametrize("probe", ["gather", "kernel"])
@pytest.mark.parametrize("num_buckets", [32, 256])
@pytest.mark.parametrize("op", ["update", "delete"])
def test_mutations_on_stash_heavy_tables_match_reference(op, num_buckets,
                                                         probe):
    kw, f, n = _heavy(num_buckets)
    jcfg, tcfg = cfgs(**kw)
    rng = np.random.RandomState(3)
    K, V = keys_vals(_queries(n, rng), seed=4)
    mask = rng.rand(len(K)) > 0.1
    jt = ch.ContinuityTable(**{k: jnp.asarray(v) for k, v in f.items()})
    tt = table_from_numpy(f, "cpu")
    if op == "update":
        jt2, jok, jc = ch.update(jcfg, jt, K, V, jnp.asarray(mask))
        _, tok, tc = tch.update(tcfg, tt, K, V, mask, probe=probe)
    else:
        jt2, jok, jc = ch.delete(jcfg, jt, K, jnp.asarray(mask))
        _, tok, tc = tch.delete(tcfg, tt, K, mask, probe=probe)
    assert_tables_equal(jt2, tt)
    assert_same(jok, tok)
    assert_ledgers_equal(jc, tc)


class _LargestOutput(TorchDispatchMode):
    """Records the most elements any op's output held."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


def test_lookup_over_a_large_stash_forms_no_dense_compare():
    """T >= 2**22 stash slots, B = 2**14: the dense compare would hold
    2**36 lanes of 4 key words; the index answers every query as a host
    oracle of the live entries does, and no op's output grows past a few
    times T."""
    cfg = tch.ContinuityConfig(num_buckets=2 ** 16, stash_frac=7.0)
    T, P = cfg.stash_slots, cfg.num_pairs
    assert T >= 2 ** 22
    t = tch.create(cfg, "cpu")
    rng = np.random.RandomState(5)
    n_live = 2 ** 20
    ids = rng.choice(T, n_live, replace=False)
    K, V = keys_vals(np.arange(n_live) + 10 ** 7, seed=6)
    kt = torch.from_numpy(K.view(np.int32))
    home, _ = tch.locate(cfg, kt)
    t.stash_keys[torch.from_numpy(ids)] = kt
    t.stash_vals[torch.from_numpy(ids)] = torch.from_numpy(V.view(np.int32))
    t.stash_meta[torch.from_numpy(ids)] = (home + 1).to(torch.int32)
    q = np.concatenate([rng.choice(n_live, 2 ** 13, replace=False),
                        n_live + rng.choice(n_live, 2 ** 13)])
    Q, _ = keys_vals(q + 10 ** 7)
    with _LargestOutput() as mode:
        res = tch.lookup(cfg, t, Q)
    assert mode.most < 4 * (T + P)
    want = q < n_live
    np.testing.assert_array_equal(res.found.numpy(), want)
    np.testing.assert_array_equal(res.slot.numpy()[want],
                                  cfg.total_bits + ids[q[want]])
    np.testing.assert_array_equal(res.values.numpy()[want],
                                  V.view(np.int32)[q[want]])
