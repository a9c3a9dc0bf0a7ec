"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; this file imports neither JAX nor the JAX package, so it runs on a
machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer outputs must match exactly.  The plain versions are themselves
held against the JAX package on the CPU (``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import continuity as ch
from repro_torch.data import ycsb
from repro_torch.kernels import mutate, probe
from repro_torch.kernels import ops as K
from repro_torch.kernels.mutate_ref import mutate_ref
from repro_torch.kernels.probe_ref import probe_ref

pytestmark = pytest.mark.cuda
BIG = 0x7FFFFFFF


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def words(a, dev):
    return torch.from_numpy(np.ascontiguousarray(
        a.astype(np.uint32)).view(np.int32)).to(dev)


def probe_case(seed, P, S, B, fill, dev):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, 2 ** 32, size=(P, 4 * S), dtype=np.uint64)
    if fill is None:
        ind = rng.randint(0, 2 ** 32, size=(P, 1), dtype=np.uint64)
        ind[::2] |= np.uint64(1 << 31)
    else:
        ind = np.full((P, 1), fill, np.uint64)
    seg = (S * 4) // 5
    prio = np.full((2, S), BIG, np.int32)
    prio[0, :seg] = np.arange(seg)
    prio[1, list(range(S - 1, S - 1 - seg, -1))] = np.arange(seg)
    pairs = rng.randint(0, P, size=B)
    q = rng.randint(0, 2 ** 32, size=(B, 4), dtype=np.uint64)
    plant = rng.randint(0, S, size=B)
    q[::2] = rows[pairs[::2]].reshape(-1, S, 4)[np.arange(len(plant[::2])),
                                                 plant[::2]]
    fps = rng.randint(0, 2 ** 32, size=(P, 2), dtype=np.uint64)
    return (words(rows, dev), words(ind, dev), torch.from_numpy(prio).to(dev),
            torch.from_numpy(pairs.astype(np.int32)).to(dev),
            torch.from_numpy(rng.randint(0, 2, size=B).astype(np.int32))
            .to(dev), words(q, dev), words(fps, dev),
            torch.from_numpy(rng.randint(0, 4, size=B).astype(np.int32))
            .to(dev))


@pytest.mark.parametrize("S,B,fill", [(20, 1, None), (20, 4099, None),
                                      (10, 33, None), (30, 777, None),
                                      (32, 512, None), (20, 1000, 0),
                                      (20, 1000, 0xFFFFF),
                                      (20, 1000, 0xFFFFFFFF)])
def test_kernels_match_plain_versions(dev, S, B, fill):
    rows, ind, prio, pairs, par, q, fps, qfp = probe_case(S * B, 257, S, B,
                                                          fill, dev)
    n0 = probe.probe_segments.launches, mutate.mutate_segments.launches
    got = probe.probe_segments(rows, ind, prio, pairs, par, q)
    want = probe_ref(rows, ind, prio, pairs, par, q)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = probe.probe_segments(rows, ind, prio, pairs, par, q, fps, qfp)
    want = probe_ref(rows, ind, prio, pairs, par, q, fps, qfp)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = mutate.mutate_segments(rows, ind, fps, prio, pairs, par, q, qfp)
    want = mutate_ref(rows, ind, fps, prio, pairs, par, q, qfp)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    assert (probe.probe_segments.launches,
            mutate.mutate_segments.launches) == (n0[0] + 2, n0[1] + 1)


def test_wrappers_reject_operands_they_do_not_take(dev):
    rows, ind, prio, pairs, par, q, fps, qfp = probe_case(1, 64, 20, 64,
                                                          None, dev)
    with pytest.raises(ValueError, match="int32"):
        probe.probe_segments(rows, ind, prio, pairs.long(), par, q)
    with pytest.raises(ValueError, match="contiguous"):
        probe.probe_segments(rows, ind, prio, pairs, par,
                             q.t().contiguous().t())
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(64 * 4 + 1, dtype=torch.int32, device=dev)
        probe.probe_segments(rows, ind, prio, pairs, par,
                             flat[1:].view(64, 4))
    with pytest.raises(ValueError, match="expected"):
        probe.probe_segments(rows, ind.cpu(), prio, pairs, par, q)


def test_store_on_card_matches_store_on_cpu(dev):
    """The CUDA main path (kernel policy) leaves byte-identical tables and
    results to the CPU path (plain versions), stash tier included."""
    stores = [api.make_store("continuity", table_slots=2048, device=d)
              for d in ("cpu", "cuda")]
    rng = np.random.RandomState(0)
    ids = np.concatenate([np.arange(2400), rng.randint(0, 2400, 64)])
    keys, vals = ycsb.make_key(ids), ycsb.make_value(rng, len(ids))
    vals2 = ycsb.make_value(rng, len(ids))
    q = np.concatenate([keys, ycsb.negative_keys(rng, 2400, 256)])
    out = []
    for st in stores:
        t = st.create()
        t, r1 = st.insert(t, keys, vals)
        t, r2 = st.update(t, keys[::2], vals2[::2])
        t, r3 = st.delete(t, keys[1::3])
        r4 = st.lookup(t, q)
        out.append((t, [r1.ok, r2.ok, r3.ok, r4.ok, r4.values, r4.reads],
                    [r.ledger for r in (r1, r2, r3, r4)]))
    (tc, rc, lc), (tg, rg, lg) = out
    assert int(tc.count) > 0 and int((tc.stash_meta != 0).sum()) > 0
    for a, b in zip(tc, tg):
        assert torch.equal(a, b.cpu())
    for a, b in zip(rc, rg):
        assert torch.equal(a, b.cpu())
    for a, b in zip(lc, lg):
        assert [int(x) for x in a] == [int(x) for x in b]


def test_lookup_policies_agree_on_card(dev):
    cfg = ch.ContinuityConfig(num_buckets=4096)
    store = api.ContinuityStore(cfg=cfg, device="cuda")
    rng = np.random.RandomState(1)
    keys = ycsb.make_key(np.arange(30000))
    t, _ = store.insert(store.create(), keys, ycsb.make_value(rng, 30000))
    q = np.concatenate([keys[::3], ycsb.negative_keys(rng, 30000, 5000)])
    n0 = probe.probe_segments.launches
    a = store.lookup(t, q)
    assert probe.probe_segments.launches == n0 + 1
    b = store.with_policy(api.ExecPolicy(probe="gather")).lookup(t, q)
    for x, y in zip((a.ok, a.values, a.reads, *a.plan),
                    (b.ok, b.values, b.reads, *b.plan)):
        assert torch.equal(x, y)
    for x, y in zip(K.probe_lookup(cfg, t, q), ch.lookup(cfg, t, q)):
        assert torch.equal(x, y)
