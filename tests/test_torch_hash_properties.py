"""Property tests of the port: every registered scheme is a faithful map.

The port of ``tests/test_hash_properties.py``: a random op sequence applied
to every scheme of ``repro_torch.api``'s registry (``device="cpu"``) must
match a python-dict oracle, with the same hypothesis settings; and the
continuity invariant (an indicator bit is set iff its slot holds a live
item that lookup can see) holds after a batch.
"""

import numpy as np
import pytest

from _propcheck import given, settings, st

from repro.data import ycsb
from repro_torch import api
from repro_torch.core import continuity as ch

CFG = ch.ContinuityConfig(num_buckets=32)
SLOTS = 320   # equal capacity across schemes (CFG's slot count)

ops_strategy = st.lists(
    st.tuples(st.sampled_from(["insert", "update", "delete", "lookup"]),
              st.integers(min_value=0, max_value=39),
              st.integers(min_value=0, max_value=2 ** 31 - 1)),
    min_size=1, max_size=60)


def key_of(i):
    return ycsb.make_key(np.array([i]))


def val_of(x):
    return np.full((1, 4), x, np.uint32)


@pytest.mark.parametrize("scheme", ["continuity", "level", "pfarm", "dense"])
@settings(max_examples=25, deadline=None)
@given(ops_strategy)
def test_scheme_matches_dict_oracle(scheme, ops):
    """One oracle, every registered scheme, through `repro_torch.api`."""
    assert scheme in api.available_schemes()
    store = api.make_store(scheme, table_slots=SLOTS, device="cpu")
    t = store.create()
    oracle = {}
    for op, i, x in ops:
        K, V = key_of(i), val_of(x)
        if op == "insert":
            if i in oracle:          # the paper's insert assumes new keys
                continue
            t, r = store.insert(t, K, V)
            if bool(r.ok[0]):
                oracle[i] = x
        elif op == "update":
            t, r = store.update(t, K, V)
            # success implies presence (may fail only if the bucket is full)
            assert (not bool(r.ok[0])) or i in oracle
            if bool(r.ok[0]):
                oracle[i] = x
        elif op == "delete":
            t, r = store.delete(t, K)
            assert bool(r.ok[0]) == (i in oracle)
            oracle.pop(i, None)
        else:
            r = store.lookup(t, K)
            assert bool(r.ok[0]) == (i in oracle)
            if i in oracle:
                assert int(r.values[0, 0]) & 0xFFFFFFFF == oracle[i]
    for i, x in oracle.items():
        r = store.lookup(t, key_of(i))
        assert bool(r.ok[0])
        assert int(r.values[0, 0]) & 0xFFFFFFFF == x
    assert int(t.count) == len(oracle)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 500), min_size=1, max_size=80, unique=True))
def test_indicator_bit_iff_live_item(ids):
    """The structural invariant behind the log-free consistency argument."""
    t = ch.create(CFG, "cpu")
    K = ycsb.make_key(np.asarray(ids))
    V = ycsb.make_value(np.random.RandomState(0), len(ids))
    t, ok, _ = ch.insert(CFG, t, K, V)
    pop = sum(bin(int(b) & 0xFFFFFFFF).count("1") for b in t.indicator)
    assert pop == int(t.count) == int(ok.sum())
    res = ch.lookup(CFG, t, K)
    for j in np.nonzero(ok.numpy())[0]:
        pair, slot = int(res.pair[j]), int(res.slot[j])
        assert (int(t.indicator[pair]) >> slot) & 1 == 1
