"""The port's distributed continuity store against the JAX package's.

One run of each side per module, both at once: the reference over 8
forced XLA host devices in a subprocess (the device count is fixed at
JAX's first use), the port on 8 gloo ranks spawned by another (process
groups are global to a process).  Both drive ``tests/_distscenarios.py``'s
scenarios on the same batches; every rank of the port gathers the global
view over its store group, and every record (each shard's table fields
after each write batch, ok / routed masks, found sets, values, ledgers,
counts, the 4-fetch lookup's found set) equals the reference's, byte for
byte, on every rank.  The walk's plain version is held against the
reference's ``_apply_routed_writes`` on crafted routed batches, with no
process group.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import continuity as JCH
from repro.core import distributed as JD
from repro_torch import convert
from repro_torch.core import continuity as ch
from repro_torch.kernels.scan_walk import routed_write

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import _distscenarios as DS  # noqa: E402

WORLD = 8


def _run(code, env_extra, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), HERE]),
               **env_extra)
    return subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=cwd)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist"))
    inputs = os.path.join(d, "inputs.npz")
    DS.make_inputs(inputs)
    ref = _run(f"import _distscenarios as d; d.reference_main({inputs!r}, "
               f"{os.path.join(d, 'ref.npz')!r})",
               {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}, d)
    port = _run("import _distscenarios as d\n"
                "if __name__ == '__main__':\n"
                f"    d.port_main({inputs!r}, {d!r}, {WORLD})", {}, d)
    for name, p in (("reference", ref), ("port", port)):
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"{name}:\n{err[-4000:]}"
    return {"inputs": dict(np.load(inputs)),
            "ref": dict(np.load(os.path.join(d, "ref.npz"))),
            "ranks": [dict(np.load(os.path.join(d, f"rank{r}.npz")))
                      for r in range(WORLD)]}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


@pytest.mark.parametrize("scen", sorted(DS.SCEN))
@pytest.mark.parametrize("rank", range(WORLD))
def test_every_record_equals_the_reference(runs, rank, scen):
    ref, port = runs["ref"], runs["ranks"][rank]
    keys = sorted(k for k in ref if k.startswith(scen + "/"))
    assert keys and sorted(k for k in port if k.startswith(scen + "/")) == keys
    for k in keys:
        a, b = _bits(ref[k]), _bits(port[k])
        assert a.shape == b.shape, k
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), k


def test_round_trip_and_counters(runs):
    """The JAX package's ``test_store_roundtrip_and_counters`` on the port."""
    r, inp = runs["ranks"][0], runs["inputs"]
    assert r["rt/ins/ok"].all() and r["rt/get/found"].all()
    assert np.array_equal(_bits(r["rt/get/values"]), _bits(inp["rt_V"]))
    assert int(r["rt/count_ins"]) == 64 and int(r["rt/count_del"]) == 0
    assert not r["rt/neg/found"].any() and r["rt/del/ok"].all()


def test_matches_local_semantics(runs):
    """The JAX package's ``test_store_matches_local_semantics`` on the port:
    after the retries every key lands and reads back as the local
    (unsharded) table of the same geometry has it."""
    r, inp = runs["ranks"][3], runs["inputs"]
    K, V = inp["sem_K"], inp["sem_V"]
    assert r["sem/inserted"].all() and r["sem/resolved"].all()
    cfg = ch.ContinuityConfig(num_buckets=512, ext_frac=0.0)
    lt = ch.create(cfg, "cpu")
    _, lok, _ = ch.insert(cfg, lt, K, V)
    assert bool(lok.all())
    lres = ch.lookup(cfg, lt, K)
    found = np.zeros(len(K), bool)
    vals = np.zeros((len(K), 4), np.int32)
    resolved = np.zeros(len(K), bool)
    for it in range(6):
        if f"sem/get{it}/routed" not in r:
            break
        take = r[f"sem/get{it}/routed"] & ~resolved
        found[take] = r[f"sem/get{it}/found"][take]
        vals[take] = r[f"sem/get{it}/values"][take]
        resolved |= take
    assert np.array_equal(found, lres.found.numpy())
    assert np.array_equal(vals[found], lres.values.numpy()[found])


def test_the_scenarios_reach_their_edge_cases(runs):
    """Capacity overflow, a refused insert (full segment), refused updates
    and deletes, retries: the comparison covers them."""
    r = runs["ranks"][0]
    assert not r["mix/w0/wrouted"].all()                 # bucket overflow
    assert (r["mix/w0/wrouted"] & ~r["mix/w0/ok"]).any()  # segment full
    assert (r["mix/w1/wrouted"] & ~r["mix/w1/ok"]).any()
    assert not r["sem/get0/routed"].all()


def test_ledger_counts_one_row_read_per_routed_key(runs):
    r = runs["ranks"][5]
    row = 8 + 8 + ch.ContinuityConfig(num_buckets=128).slots_per_pair * 32
    for tag in ("get0", "fresh1", "get2"):
        n = int(r[f"mix/{tag}/routed"].sum())
        assert r[f"mix/{tag}/ledger"].tolist() == [0, n, n * row, n]


def _crafted(seed):
    """A local ext-free table with live items, and routed entries over its
    pairs: inserts, updates, deletes of present and absent keys, repeats,
    dead and no-op entries, pairs driven full."""
    rng = np.random.RandomState(seed)
    cfg = JCH.ContinuityConfig(num_buckets=8, ext_frac=0.0)   # 4 pairs
    P, S = cfg.num_pairs, cfg.slots_per_pair
    keys = rng.randint(0, 2 ** 31, (P, S, 4)).astype(np.uint32)
    vals = rng.randint(0, 2 ** 31, (P, S, 4)).astype(np.uint32)
    ind = rng.randint(0, 2 ** 20, P).astype(np.uint32)
    table = JCH.create(cfg)._replace(
        keys=jnp.asarray(keys), vals=jnp.asarray(vals),
        indicator=jnp.asarray(ind),
        version=jnp.asarray(rng.randint(0, 9, P).astype(np.uint32)))
    N = 96
    pair = rng.randint(0, P, N).astype(np.int32)
    parity = rng.randint(0, 2, N).astype(np.int32)
    op = rng.randint(0, 4, N).astype(np.int32)
    k = rng.randint(0, 2 ** 31, (N, 4)).astype(np.uint32)
    present = rng.rand(N) < 0.5          # half the keys are live items
    slot = rng.randint(0, S, N)
    k[present] = keys[pair[present], slot[present]]
    k[N // 2:N // 2 + 8] = k[0]          # one key repeated
    pair[N // 2:N // 2 + 8], parity[N // 2:N // 2 + 8] = pair[0], parity[0]
    v = rng.randint(0, 2 ** 31, (N, 4)).astype(np.uint32)
    live = rng.rand(N) < 0.9
    return cfg, table, pair, parity, op, k, v, live


@pytest.mark.parametrize("seed", range(4))
def test_routed_walk_plain_version_equals_apply_routed_writes(seed):
    cfg, jt, pair, parity, op, k, v, live = _crafted(seed)
    jt2, jstatus = JD._apply_routed_writes(
        cfg, jt, jnp.asarray(pair), jnp.asarray(parity), jnp.asarray(op),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(live))
    tcfg = ch.ContinuityConfig(num_buckets=8, ext_frac=0.0)
    t = convert.table_from_numpy({f: np.asarray(getattr(jt, f))
                                  for f in jt._fields}, "cpu")
    status = routed_write(tcfg, t, torch.from_numpy(pair),
                          torch.from_numpy(parity), torch.from_numpy(op),
                          torch.from_numpy(k.view(np.int32)),
                          torch.from_numpy(v.view(np.int32)),
                          torch.from_numpy(live))
    assert np.array_equal(status.numpy(), np.asarray(jstatus).astype(np.int32))
    assert 0 < int(status.sum()) < len(op)
    mine = convert.table_to_numpy(t)
    for f in jt2._fields:
        assert np.array_equal(_bits(mine[f]), _bits(np.asarray(getattr(jt2, f)))), f
