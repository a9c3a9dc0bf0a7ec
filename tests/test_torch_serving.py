"""The port's serving path against the JAX package's, on the CPU.

``smoke_config("yi-6b")`` (3 layers, d 128, 8 heads, 1 KV head, head dim
32, float32) with the JAX package's ``init_params`` carried across by
``convert.params_from_numpy``; page geometry ``shards=2, page_size=16``,
batch 4, as ``tests/test_serving.py``.  The same prompts and fed tokens
(numpy, from seeds) go through both sides.

Tolerances: logits within atol 1e-4, rtol 1e-4 (float32 on both sides;
only the order of the sums differs); page-table fields, ``next_free``,
``seq_ids``, ``seq_lens``, ``cur_page`` and ``cur_off`` byte-equal; pools
within 1e-5 (the float32 logits differ by at most ~5e-7 here).  The
bfloat16 case holds logits within 2e-2, about 13x the largest difference
seen (1.5e-3 on logits of std 0.23): a bf16 rounding that lands
differently after a differently ordered matmul moves a logit by ~1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.models.config import ShapeConfig as JShape
from repro.serving import engine as JE
from repro.serving import kvcache as JKC
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeConfig
from repro_torch.serving import engine as E
from repro_torch.serving import kvcache as KC

SMALL = ("next_free", "seq_ids", "seq_lens", "cur_page", "cur_off")
PROMPT, STEPS = 32, 20


def jax_state(cache) -> dict:
    out = {f: np.asarray(getattr(cache, f)) for f in SMALL + ("kpool",
                                                              "vpool")}
    out["table"] = {f: np.asarray(getattr(cache.table, f))
                    for f in cache.table._fields}
    return out


def assert_same_state(jcache, tcache):
    j, t = jax_state(jcache), convert.cache_to_numpy(tcache)
    assert set(j["table"]) == set(t["table"])
    for f in j["table"]:
        assert np.array_equal(j["table"][f], t["table"][f]), f
    for f in SMALL:
        assert j[f].dtype == t[f].dtype and np.array_equal(j[f], t[f]), f
    for f in ("kpool", "vpool"):
        np.testing.assert_allclose(t[f], np.asarray(j[f], np.float32),
                                   atol=1e-5, rtol=0)


def close(jlogits, tlogits, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(tlogits.float().numpy(),
                               np.asarray(jlogits, np.float32),
                               atol=atol, rtol=rtol)


class Run:
    """One model on both sides: JAX params carried into the port."""

    def __init__(self, dtype="float32"):
        self.jcfg = dataclasses.replace(jax_smoke_config("yi-6b"),
                                        dtype=dtype)
        self.cfg = dataclasses.replace(smoke_config("yi-6b"), dtype=dtype)
        self.jparams = JT.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.params = convert.params_from_numpy(
            jax.tree.map(np.asarray, self.jparams), self.cfg, "cpu")
        self.jgeom = JKC.make_geometry(
            self.jcfg, JShape("t", seq_len=128, global_batch=4,
                              kind="decode"), shards=2, page_size=16)
        self.geom = KC.make_geometry(
            self.cfg, ShapeConfig("t", seq_len=128, global_batch=4,
                                  kind="decode"), shards=2, page_size=16,
            device="cpu")
        self.jstep = jax.jit(lambda p, t, c: JE.serve_step(
            self.jcfg, self.jgeom, p, t, c))
        rng = np.random.RandomState(2)
        self.prompt = rng.randint(0, self.cfg.vocab, (4, PROMPT)).astype(
            np.int32)
        self.fed = rng.randint(0, self.cfg.vocab, (4, STEPS)).astype(np.int32)

    def prefill(self):
        jl, jc = JE.prefill(self.jcfg, self.jgeom, self.jparams,
                            jnp.asarray(self.prompt), JKC.create_cache(
                                self.jgeom))
        tl, tc = E.prefill(self.cfg, self.geom, self.params,
                           torch.from_numpy(self.prompt),
                           KC.create_cache(self.geom))
        return (jl, jc), (tl, tc)

    def jax_decode(self, jc, steps=STEPS):
        out = []
        for i in range(steps):
            jl, jc = self.jstep(self.jparams, jnp.asarray(self.fed[:, i]), jc)
            out.append(jl)
        return out, jc

    def port_decode(self, tc, steps=STEPS):
        out = []
        for i in range(steps):
            tl, tc = E.serve_step(self.cfg, self.geom, self.params,
                                  torch.from_numpy(self.fed[:, i]), tc)
            out.append(tl)
        return out, tc


@pytest.fixture(scope="module")
def f32():
    """Prefill + 20 decode steps on both sides, states taken after each."""
    r = Run()
    (jl, jc), (tl, tc) = r.prefill()
    after_prefill = (jl, jax_state(jc), tl, convert.cache_to_numpy(tc))
    jsteps, jc = r.jax_decode(jc)
    tsteps, tc = r.port_decode(tc)
    return r, after_prefill, (jsteps, jc, tsteps, tc)


def test_prefill_matches(f32):
    _, (jl, j, tl, t), _ = f32
    close(jl, tl)
    for f in j["table"]:
        assert np.array_equal(j["table"][f], t["table"][f]), f
    for f in SMALL:
        assert np.array_equal(j[f], t[f]), f
    for f in ("kpool", "vpool"):
        np.testing.assert_allclose(t[f], j[f], atol=1e-5, rtol=0)
    assert int(t["table"]["count"].sum()) == 4 * PROMPT // 16


def test_decode_steps_match(f32):
    _, _, (jsteps, jc, tsteps, tc) = f32
    for jl, tl in zip(jsteps, tsteps):
        close(jl, tl)
    assert_same_state(jc, tc)
    pages = -(-(PROMPT + STEPS) // 16)
    assert sum(int(t.count) for t in tc.table) == 4 * pages


def test_decode_equals_own_forward(f32):
    """The port's paged decode logits equal its own dense forward over the
    same history (the invariant of ``tests/test_serving.py``)."""
    r, _, (_, _, tsteps, _) = f32
    hist = torch.from_numpy(np.concatenate([r.prompt, r.fed], 1))
    x, _ = T.forward(r.cfg, r.params, hist)
    want = T.logits_fn(r.cfg, r.params, x)[:, -1]
    torch.testing.assert_close(tsteps[-1], want, atol=3e-3, rtol=1e-3)


def test_release_matches(f32):
    r, _, (_, jc, _, tc) = f32
    for shard, slot in ((0, 1), (1, 0)):
        jc = JE.release_sequence(r.jgeom, jc, shard, slot)
        tc = E.release_sequence(r.geom, tc, shard, slot)
        assert_same_state(jc, tc)
    assert int(tc.seq_lens[0, 1]) == 0 and int(tc.seq_ids[0, 1]) >= 4
    # the freed slots take new sequences on both sides
    jsteps, jc = r.jax_decode(jc, 3)
    tsteps, tc = r.port_decode(tc, 3)
    for jl, tl in zip(jsteps, tsteps):
        close(jl, tl)
    assert_same_state(jc, tc)


def test_decode_from_carried_cache():
    """A cache built by the JAX prefill, carried into the port with
    ``cache_from_numpy``, decodes like the JAX package; ``cache_to_numpy``
    gives back what went in."""
    r = Run()
    jl, jc = JE.prefill(r.jcfg, r.jgeom, r.jparams, jnp.asarray(r.prompt),
                        JKC.create_cache(r.jgeom))
    tc = convert.cache_from_numpy(jax_state(jc), "cpu")
    back = convert.cache_to_numpy(tc)
    assert_same_state(jc, tc)
    assert all(np.array_equal(back[f], jax_state(jc)[f]) for f in SMALL)
    jsteps, jc = r.jax_decode(jc, 4)
    tsteps, tc = r.port_decode(tc, 4)
    for a, b in zip(jsteps, tsteps):
        close(a, b)
    assert_same_state(jc, tc)


def test_bf16_prefill_and_decode():
    r = Run("bfloat16")
    (jl, jc), (tl, tc) = r.prefill()
    assert tc.kpool.dtype == torch.bfloat16
    assert r.params["blocks"]["wq"].dtype == torch.bfloat16
    assert r.params["lm_head"].dtype == torch.float32
    close(jl, tl, atol=2e-2, rtol=0)
    jsteps, jc = r.jax_decode(jc, 4)
    tsteps, tc = r.port_decode(tc, 4)
    for a, b in zip(jsteps, tsteps):
        close(a, b, atol=2e-2, rtol=0)


def test_content_page_keys_bit_equal():
    toks = np.random.RandomState(0).randint(0, 99, size=(6, 64)).astype(
        np.int32)
    toks[3:] = toks[:3]
    toks[5, 20] += 1
    want = np.asarray(JE.content_page_keys(jnp.asarray(toks), 16))
    got = E.content_page_keys(torch.from_numpy(toks), 16).numpy()
    assert np.array_equal(got.view(np.uint32), want)


def test_geometry_and_device_rules():
    cfg = smoke_config("yi-6b")
    shape = ShapeConfig("t", seq_len=128, global_batch=4, kind="decode")
    g = KC.make_geometry(cfg, shape, shards=2, page_size=16, device="cpu")
    jg = JKC.make_geometry(jax_smoke_config("yi-6b"), JShape(
        "t", seq_len=128, global_batch=4, kind="decode"), shards=2,
        page_size=16)
    for f in ("layers", "kv_heads", "head_dim", "page_size", "max_pages",
              "shards", "batch_per_shard", "pool_pages", "kv_dtype"):
        assert getattr(g, f) == getattr(jg, f), f
    assert dataclasses.asdict(g.store.cfg) == dataclasses.asdict(
        jg.store.cfg)
    # int8 pages and the merged path: the reference's fields, its scales
    g8 = KC.make_geometry(cfg, shape, shards=2, kv_dtype="int8",
                          merged_attn=True, device="cpu")
    jg8 = JKC.make_geometry(jax_smoke_config("yi-6b"), JShape(
        "t", seq_len=128, global_batch=4, kind="decode"), shards=2,
        kv_dtype="int8", merged_attn=True)
    for f in ("kv_dtype", "merged_attn", "pool_pages"):
        assert getattr(g8, f) == getattr(jg8, f), f
    c8, jc8 = KC.create_cache(g8), JKC.create_cache(jg8)
    for f in ("kpool", "kscale", "vscale"):
        t, j = getattr(c8, f), getattr(jc8, f)
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
    assert KC.create_cache(g).kscale is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            KC.make_geometry(cfg, shape, shards=2)


ARCH_NAMES = ["starcoder2-15b", "minitron-8b", "qwen1.5-32b", "yi-6b",
              "granite-moe-1b-a400m", "granite-moe-3b-a800m",
              "musicgen-large", "hymba-1.5b", "llava-next-34b", "mamba2-370m"]


@pytest.mark.parametrize("twin", [False, True])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_configs_match_reference(name, twin):
    """Each of the reference's ten configs and its smoke twin equal the
    port's, field by field, with the same derived sizes; the registry
    holds all ten in the reference's order."""
    from repro.configs import ARCHS as JARCHS
    from repro.configs import get_arch as jax_get_arch
    from repro_torch.configs import ARCHS, get_arch
    assert list(ARCHS) == list(JARCHS) == ARCH_NAMES
    jc = jax_smoke_config(name) if twin else jax_get_arch(name)
    tc = smoke_config(name) if twin else get_arch(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.hd, tc.padded_vocab, tc.param_count, tc.active_param_count,
            tc.sub_quadratic, tc.has_attention) == (
        jc.hd, jc.padded_vocab, jc.param_count, jc.active_param_count,
        jc.sub_quadratic, jc.has_attention)


def test_oversubscribed_pool_matches():
    """A physical pool of half the worst-case logical pages (the
    reference's ``TestOversubscription``): the same pages, logits and
    tables as the JAX package."""
    r = Run()
    shape = dict(seq_len=128, global_batch=4, kind="decode")
    r.jgeom = JKC.make_geometry(r.jcfg, JShape("t", **shape), shards=2,
                                page_size=16, oversub=0.5)
    r.geom = KC.make_geometry(r.cfg, ShapeConfig("t", **shape), shards=2,
                              page_size=16, oversub=0.5, device="cpu")
    assert r.geom.pool_pages == r.jgeom.pool_pages == 8
    r.jstep = jax.jit(lambda p, t, c: JE.serve_step(r.jcfg, r.jgeom, p, t, c))
    jsteps, jc = r.jax_decode(JKC.create_cache(r.jgeom), 18)
    tsteps, tc = r.port_decode(KC.create_cache(r.geom), 18)
    for a, b in zip(jsteps, tsteps):
        close(a, b)
    assert_same_state(jc, tc)
