"""The port's paged serving step under a mesh against the JAX package's.

``smoke_config("yi-6b")`` (and ``granite-moe-1b-a400m`` for the moe
family) with the reference's parameters (``PRNGKey(0)``), page geometry
``shards=2, page_size=16``, batch 4.  The reference runs under a (2, 2)
``("data", "model")`` mesh of 4 forced XLA host devices, jitted with
its dry run's shardings (GSPMD: pools split over data shards and page
tokens, split-KV decode): a prefill of 32 tokens keeping 27, then 6
``serve_step`` calls (the int8 case: 10 steps from an empty cache).  The
port runs the same on 4 gloo ranks as a (2, 2) mesh, each rank on its
shard of the cache (``kvcache.shard_cache``: its data shard's sequences
and page table, its 8 of each page's 16 tokens).  One spawn of each
side per module (``tests/_shardserve.py``), both at once.

Held, on every rank: the page tables (every store-table field),
``next_free`` and the sequence fields byte-equal to the reference's
for the rank's data shard (so every model rank of a data group keeps the
same tables); the pools of its slice within 1e-5 (int8 pools: the
``tests/test_torch_int8_kv.py`` rule, entries at most 1 apart and 99.9 %
equal, scales within 1e-6 relative); the logits within atol 1e-4 / rtol
1e-4 (float32).  The bfloat16 model holds its logits and pools within
2e-2 (``tests/test_torch_serving.py``'s bfloat16 bar: a bf16 rounding
that lands differently after a differently ordered sum moves a value by
an ulp).  The gathered cache (``kvcache.gather_cache``) equals the
reference's global one the same way, and the port's sharded run equals
its own unsharded run.  On a (1, 1) mesh (one gloo rank) the sharded run
equals the unsharded one bit for bit: logits, pools, page tables.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import _shardserve as SS  # noqa: E402

CASES = sorted(SS.CASES)
SLICE = SS.PAGE // SS.MESH[1]


def _run(code, env_extra, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), HERE]),
               **env_extra)
    return subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=cwd)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shardserve"))
    inputs = os.path.join(d, "inputs.npz")
    SS.make_inputs(inputs)
    ref = _run(f"import _shardserve as s; s.reference_main("
               f"{os.path.join(d, 'ref.npz')!r})",
               {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}, d)
    port = _run("import _shardserve as s\n"
                "if __name__ == '__main__':\n"
                f"    s.port_main({inputs!r}, {d!r})", {}, d)
    for name, p in (("reference", ref), ("port", port)):
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"{name}:\n{err[-4000:]}"
    return {"ref": dict(np.load(os.path.join(d, "ref.npz"))),
            "ranks": [dict(np.load(os.path.join(d, f"rank{r}.npz")))
                      for r in range(SS.WORLD)]}


def _tol(case):
    return 2e-2 if SS.CASES[case]["dtype"] == "bfloat16" else None


def _same_state(want: dict, got: dict, case: str, what: str) -> None:
    """``got`` (one side's state, as ``_shardserve`` saves it) equals
    ``want``: integer fields byte for byte, pools within the case's
    tolerance."""
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for f, a in want.items():
        b = got[f]
        assert a.shape == b.shape, (what, f, a.shape, b.shape)
        if f not in SS.POOLS:
            assert np.array_equal(a, b), (what, f)
        elif f in ("kscale", "vscale"):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0,
                                       err_msg=f"{what} {f}")
        elif a.dtype == np.int8:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1, (what, f)
            assert (diff == 0).mean() >= 0.999, (what, f)
        else:
            np.testing.assert_allclose(b, a, atol=_tol(case) or 1e-5,
                                       rtol=0, err_msg=f"{what} {f}")


def _close(want, got, case):
    tol = _tol(case)
    if tol:
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _reference_shard(runs, case, rank) -> dict:
    """The reference's global state cut to ``rank``'s shard: its data
    shard's tables and fields, its slice of each page's tokens."""
    ds, r = divmod(rank, SS.MESH[1])
    out = {}
    for k, v in runs["ref"].items():
        if not k.startswith(case + "/") or k.endswith("/logits"):
            continue
        f = k[len(case) + 1:]
        if f in SS.POOLS:
            v = v[:, ds:ds + 1, :, :, r * SLICE:(r + 1) * SLICE]
        else:
            v = v[ds:ds + 1]
        out[f] = v
    return out


def _side(rec, case, prefix) -> dict:
    head = f"{case}/{prefix}."
    return {k[len(head):]: v for k, v in rec.items() if k.startswith(head)}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rank", range(SS.WORLD))
def test_every_rank_holds_the_references_shard(runs, case, rank):
    _same_state(_reference_shard(runs, case, rank),
                _side(runs["ranks"][rank], case, "local"), case,
                f"rank {rank}")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rank", range(SS.WORLD))
def test_logits_equal_the_reference(runs, case, rank):
    want = runs["ref"][f"{case}/logits"]
    got = runs["ranks"][rank][f"{case}/logits"]
    assert got.shape == want.shape
    _close(want, got, case)


@pytest.mark.parametrize("case", CASES)
def test_gathered_cache_equals_the_reference(runs, case):
    want = {k[len(case) + 1:]: v for k, v in runs["ref"].items()
            if k.startswith(case + "/") and not k.endswith("/logits")}
    _same_state(want, _side(runs["ranks"][0], case, "gathered"), case,
                "gathered")


@pytest.mark.parametrize("case", CASES)
def test_sharded_run_equals_the_ports_unsharded_run(runs, case):
    r0 = runs["ranks"][0]
    _close(r0[f"{case}/unsharded_logits"], r0[f"{case}/logits"], case)
    _same_state(_side(r0, case, "unsharded"), _side(r0, case, "gathered"),
                case, "unsharded")


@pytest.mark.parametrize("case", CASES)
def test_model_ranks_of_a_data_group_keep_equal_tables(runs, case):
    """The page tables are replicated over the model axis: each model rank
    does the same upkeep on its own copy, with no collective, and the
    copies stay byte-equal."""
    for ds in range(SS.MESH[0]):
        group = [runs["ranks"][ds * SS.MESH[1] + r]
                 for r in range(SS.MESH[1])]
        first = _side(group[0], case, "local")
        for other in group[1:]:
            o = _side(other, case, "local")
            for f in first:
                if f not in SS.POOLS:
                    assert np.array_equal(first[f], o[f]), (ds, f)


def test_each_rank_holds_its_data_shard_and_token_slice(runs):
    """(local data shards, slices per page, this rank's slice, its first
    token): the model coordinate picks the slice, the data coordinate the
    shard; the decode steps wrote both slices of the page they ended in."""
    for rank, rec in enumerate(runs["ranks"]):
        r = rank % SS.MESH[1]
        for case in CASES:
            assert tuple(rec[f"{case}/slice"]) == (1, SS.MESH[1], r,
                                                   r * SLICE)
    lens = runs["ref"]["float32/seq_lens"]
    assert (lens == SS.PROMPT_LEN + SS.CASES["float32"]["steps"]).all()
    assert SLICE <= SS.PROMPT_LEN % SS.PAGE          # starts in slice 1
    assert SS.PROMPT_LEN + SS.CASES["float32"]["steps"] > 2 * SS.PAGE


@pytest.mark.parametrize("case", CASES)
def test_world1_mesh_equals_the_unsharded_run_bit_for_bit(runs, case):
    """At world 1 every placement is ``Replicate()`` and the slice is the
    whole page: the slice mode merged over one slice and the DTensor
    layers give the unsharded run's bits (what phase 7b (c) of
    ``chip_smoke.py`` holds on the card)."""
    r0 = runs["ranks"][0]
    head = f"world1/{case}/"
    assert tuple(r0[head + "slice"]) == (2, 1, 0, 0)
    assert np.array_equal(r0[head + "logits"], r0[head + "unsharded_logits"])
    local = _side(r0, "world1/" + case, "local")
    plain = _side(r0, "world1/" + case, "unsharded")
    assert set(local) == set(plain)
    for f in plain:
        assert np.array_equal(local[f], plain[f]), f
