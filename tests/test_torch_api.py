"""The PyTorch port's store surface (``repro_torch.api``) against the JAX
package's, on the CPU, plus the port's device and import rules.

Both stores take the same numpy-seeded batches; tables, per-op flags,
lookup results, verb plans and the `CostLedger` (paper Table I: continuity
2/2/1 PM writes per insert/update/delete) must match exactly.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.data import ycsb
from repro_torch import api
from repro_torch.convert import table_from_numpy, table_to_numpy

ROOT = Path(__file__).resolve().parents[1]
SLOTS = 1024
N = 300


def keys_vals(n=N, seed=0, start=0):
    rng = np.random.RandomState(seed)
    return ycsb.make_key(np.arange(start, start + n)), ycsb.make_value(rng, n)


def cpu_store(**kw):
    return api.make_store("continuity", table_slots=SLOTS, device="cpu", **kw)


def as_np(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a


def assert_same(want, got):
    w, g = as_np(want), as_np(got)
    if w.dtype == np.uint32:
        g = g.astype(np.int64).astype(np.uint32)
    np.testing.assert_array_equal(g, w)


def assert_results_equal(jres, tres):
    for name in ("ok", "values", "reads"):
        a, b = getattr(jres, name), getattr(tres, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert_same(a, b)
    for a, b in zip(jres.ledger, tres.ledger):
        assert int(a) == int(b)
    if jres.plan is not None:
        for a, b in zip(jres.plan, tres.plan):
            assert_same(a, b)


def test_registry_and_protocol():
    assert api.available_schemes() == ("continuity", "level", "pfarm",
                                       "dense")
    assert api.available_schemes() == japi.available_schemes()
    store = cpu_store()
    assert isinstance(store, api.HashStore)
    assert store.device == "cpu"
    assert store.policy == api.ExecPolicy()
    assert hash(store) == hash(dataclasses.replace(store))
    with pytest.raises(ValueError, match="unknown scheme"):
        api.make_store("cuckoo")
    with pytest.raises(ValueError, match="already registered"):
        api.register_scheme("continuity", api.ContinuityStore.from_slots)


def test_policy_defaults_and_validation():
    p = api.ExecPolicy()
    assert (p.engine, p.probe, p.mutate, p.use_fp) == \
        ("wave", "kernel", "kernel", True)
    for bad in (dict(engine="quantum"), dict(probe="pallas"),
                dict(mutate="bogus")):
        with pytest.raises(ValueError):
            api.ExecPolicy(**bad)


def test_serial_engine_raises_until_ported():
    store = cpu_store(policy=api.ExecPolicy(engine="serial"))
    K, V = keys_vals(n=8)
    t = store.create()
    for call in (lambda: store.insert(t, K, V),
                 lambda: store.update(t, K, V),
                 lambda: store.delete(t, K)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def test_cuda_is_the_default_device_and_never_falls_back():
    store = api.make_store("continuity", table_slots=SLOTS)
    assert store.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only rule cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.create()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table_from_numpy({}, "cuda")


@pytest.mark.parametrize("mutate", ["gather", "reference", "kernel"])
def test_store_matches_reference_store(mutate):
    """Same batches through both stores (JAX: its default gather policy):
    byte-equal tables, equal flags, ledgers and lookups."""
    K, V = keys_vals()
    V2 = keys_vals(seed=7)[1]
    js = japi.make_store("continuity", table_slots=SLOTS)
    ts = cpu_store(policy=api.ExecPolicy(mutate=mutate))
    assert dataclasses.asdict(js.cfg) == dataclasses.asdict(ts.cfg)
    jt, jr = js.insert(js.create(), K, V)
    tt, tr = ts.insert(ts.create(), K, V)
    assert_results_equal(jr, tr)
    jt, jr = js.update(jt, K[::3], V2[::3])
    tt, tr = ts.update(tt, K[::3], V2[::3])
    assert_results_equal(jr, tr)
    jt, jr = js.delete(jt, K[1::2])
    tt, tr = ts.delete(tt, K[1::2])
    assert_results_equal(jr, tr)
    got = table_to_numpy(tt)
    for f in jt._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jt, f)))
    q = np.concatenate([K, ycsb.negative_keys(np.random.RandomState(2),
                                              N, 64)])
    assert_results_equal(js.lookup(jt, q), ts.lookup(tt, q))
    assert_same(js.version_stamp(jt, q), ts.version_stamp(tt, q))
    for a, b in zip(js.version_read_plan(jt, q), ts.version_read_plan(tt, q)):
        assert_same(a, b)
    assert_same(js.load_factor(jt), ts.load_factor(tt))
    assert js.stats(jt) == ts.stats(tt)


def test_ledger_reproduces_paper_table1():
    K, V = keys_vals()
    store = api.make_store("continuity", table_slots=4096, device="cpu")
    t = store.create()
    t, ins = store.insert(t, K, V)
    t, upd = store.update(t, K, keys_vals(seed=3)[1])
    t, dele = store.delete(t, K[: N // 2])
    cells = (ins.ledger.pm_per_op(), upd.ledger.pm_per_op(),
             dele.ledger.pm_per_op())
    assert cells == (2.0, 2.0, 1.0)
    assert store.lookup(t, K).ledger.reads_per_op() == pytest.approx(1.0)


def test_cost_ledger_matches_reference():
    from repro.core import pmem as jp
    from repro_torch.core import pmem as tp
    parts = [dict(pm_writes=6, rdma_reads=4, bytes_fetched=528, ops=3),
             dict(pm_writes=2, ops=1), dict(rdma_reads=1, ops=0)]
    j, t = jp.CostLedger.zero(), tp.CostLedger.zero()
    for kw in parts:
        j = j.merge(jp.CostLedger.zero().add(**kw))
        t = t.merge(tp.CostLedger.zero().add(**kw))
    assert [int(x) for x in j] == [int(x) for x in t]
    for name in ("pm_per_op", "reads_per_op", "bytes_per_op"):
        assert getattr(j, name)() == getattr(t, name)()
    assert tp.CostLedger.zero().pm_per_op() == 0.0
    assert tp.CACHE_LINE == jp.CACHE_LINE
    for n in (0, 1, 64, 65, 656):
        assert tp.lines_touched(n) == jp.lines_touched(n)


def test_crud_roundtrip_and_masks():
    store = cpu_store()
    K, V = keys_vals()
    t = store.create()
    t, ins = store.insert(t, K, V)
    assert bool(ins.ok.all()) and int(t.count) == N
    hit = store.lookup(t, K)
    assert bool(hit.ok.all())
    np.testing.assert_array_equal(hit.values.numpy().view(np.uint32), V)
    assert bool((hit.reads >= 1).all())
    neg = ycsb.negative_keys(np.random.RandomState(9), N, 64)
    assert not bool(store.lookup(t, neg).ok.any())
    mask = np.arange(N) % 2 == 0
    t, dele = store.delete(t, K, mask)
    assert np.array_equal(dele.ok.numpy(), mask)
    assert int(dele.ledger.ops) == int(mask.sum())
    assert np.array_equal(store.lookup(t, K).ok.numpy(), ~mask)
    assert 0.0 < float(store.load_factor(t)) < 1.0


@pytest.mark.parametrize("probe", ["reference", "kernel"])
def test_probe_policies_match_gather(probe):
    K, V = keys_vals(n=96)
    gather = cpu_store(policy=api.ExecPolicy(probe="gather"))
    t, _ = gather.insert(gather.create(), K, V)
    for use_fp in (True, False):
        kern = gather.with_policy(api.ExecPolicy(probe=probe, use_fp=use_fp))
        for q in (K, ycsb.negative_keys(np.random.RandomState(2), 96, 32)):
            a, b = kern.lookup(t, q), gather.lookup(t, q)
            assert torch.equal(a.ok, b.ok)
            assert torch.equal(a.values, b.values)
            assert torch.equal(a.reads, b.reads)
            assert all(torch.equal(x, y) for x, y in zip(a.plan, b.plan))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant):
                    yield str(arg.value)


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
