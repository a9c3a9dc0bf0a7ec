"""The port's int8 KV pages and merged decode path against the JAX package's,
on the CPU.

``smoke_config("yi-6b")`` (float32) with the JAX package's weights carried
across, page geometry ``shards=2, page_size=16``, batch 4, as
``tests/test_serving.py``; the same tokens (numpy, from seeds) on both
sides.

Tolerances: ``quant_store`` / ``dequant`` byte-equal (the same float32
arithmetic); logits within 3e-3 / 1e-3 (``tests/test_serving.py``'s
decode bar: float inputs that differ in the last bit can quantize to
neighbouring int8 values); int8 pool entries equal in at least 99.9 % of
elements and never more than 1 apart, scales within 1e-6 relative; the
merged path within 2e-5 (float32, only the order of sums differs); the
plain int8 attention within float32 2e-5 / bfloat16 6e-2
(``tests/test_kernels.py``).

The port's int8 prefill repairs the reference's (ROADMAP Queue 3): the
reference writes the prompt's float k/v straight into the int8 pools and
no scale, so every prompt token reads back as 0; the port quantizes them
as decode does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import ShapeConfig as JShape
from repro.serving import engine as JE
from repro.serving import kvcache as JKC
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops as K
from repro_torch.kernels.paged_attn_ref import paged_attention_ref
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeConfig
from repro_torch.serving import engine as E
from repro_torch.serving import kvcache as KC

SMALL = ("next_free", "seq_ids", "seq_lens", "cur_page", "cur_off")
STEPS, PROMPT = 24, 32
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def quant_inputs(seed):
    """(64, 4, 32) values: random rows, rows whose quotients are exact
    halves (scale 1/64: a row maximum of 127/64 and entries (k + 0.5)/64,
    ties rounded to even), an all-zero row and a row of one sign."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(64, 4, 32) * 0.7).astype(np.float32)
    ties = (np.arange(32) - 16 + 0.5).astype(np.float32) / 64
    ties[0] = 127 / 64
    x[0, 0], x[0, 1] = ties, -ties
    x[1, 2] = 0.0
    x[2, 3] = np.abs(x[2, 3])
    return x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_quant_store_and_dequant_byte_equal(dtype, seed):
    jdt, tdt = DTYPES[dtype]
    x = quant_inputs(seed)
    jq, js = JKC.quant_store(jnp.asarray(x, jdt))
    tq, ts = KC.quant_store(torch.from_numpy(x).to(tdt))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    # the ties went to the even neighbour, the zero row to zeros
    assert tq[0, 0, 16].item() == 0 and tq[0, 0, 17].item() == 2
    assert not tq[1, 2].any() and ts[1, 2].item() == np.float32(1e-8) / 127
    jd = JKC.dequant(jq, js, jdt)
    td = KC.dequant(tq, ts, tdt)
    assert td.dtype == tdt
    assert np.array_equal(np.asarray(jd, np.float32), td.float().numpy())


class Run:
    """One model on both sides, the JAX weights carried into the port."""

    def __init__(self, kv_dtype="int8", merged=False):
        self.jcfg = jax_smoke_config("yi-6b")
        self.cfg = smoke_config("yi-6b")
        self.jparams = JT.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.params = convert.params_from_numpy(
            jax.tree.map(np.asarray, self.jparams), self.cfg, "cpu")
        shape = dict(seq_len=128, global_batch=4, kind="decode")
        self.jgeom = JKC.make_geometry(self.jcfg, JShape("t", **shape),
                                       shards=2, page_size=16,
                                       kv_dtype=kv_dtype, merged_attn=merged)
        self.geom = KC.make_geometry(self.cfg, ShapeConfig("t", **shape),
                                     shards=2, page_size=16,
                                     kv_dtype=kv_dtype, merged_attn=merged,
                                     device="cpu")
        self.jstep = jax.jit(lambda p, t, c: JE.serve_step(
            self.jcfg, self.jgeom, p, t, c))
        rng = np.random.RandomState(3)
        self.prompt = rng.randint(0, self.cfg.vocab, (4, PROMPT)).astype(
            np.int32)
        self.toks = rng.randint(0, self.cfg.vocab, (4, STEPS)).astype(
            np.int32)

    def jax_decode(self, toks, jc=None):
        jc = JKC.create_cache(self.jgeom) if jc is None else jc
        out = []
        for t in range(toks.shape[1]):
            jl, jc = self.jstep(self.jparams, jnp.asarray(toks[:, t]), jc)
            out.append(np.asarray(jl))
        return out, jc

    def port_decode(self, toks, tc=None, geom=None):
        geom = geom or self.geom
        tc = KC.create_cache(geom) if tc is None else tc
        out = []
        for t in range(toks.shape[1]):
            tl, tc = E.serve_step(self.cfg, geom, self.params,
                                  torch.from_numpy(toks[:, t]), tc)
            out.append(tl.numpy())
        return out, tc


def close(j, t, atol=3e-3, rtol=1e-3):
    np.testing.assert_allclose(t, np.asarray(j, np.float32), atol=atol,
                               rtol=rtol)


@pytest.fixture(scope="module")
def int8_decode():
    """Token-by-token int8 decode, 24 steps, on both sides."""
    r = Run()
    jout, jc = r.jax_decode(r.toks)
    tout, tc = r.port_decode(r.toks)
    return r, jout, jc, tout, tc


def test_int8_token_by_token_decode_matches(int8_decode):
    r, jout, jc, tout, tc = int8_decode
    assert tc.kpool.dtype == torch.int8 and tc.kscale.shape == (
        r.cfg.n_layers, 2, r.geom.pool_pages, r.cfg.n_kv_heads, 16, 1)
    for jl, tl in zip(jout, tout):
        close(jl, tl)
    t = convert.cache_to_numpy(tc)
    for f in jc.table._fields:
        assert np.array_equal(np.asarray(getattr(jc.table, f)),
                              t["table"][f]), f
    for f in SMALL:
        assert np.array_equal(np.asarray(getattr(jc, f)), t[f]), f
    for f in ("kpool", "vpool"):
        j = np.asarray(getattr(jc, f))
        assert t[f].dtype == np.int8 and j.dtype == np.int8
        diff = np.abs(t[f].astype(np.int32) - j.astype(np.int32))
        assert diff.max() <= 1, f
        assert (diff == 0).mean() >= 0.999, (f, (diff == 0).mean())
        assert np.count_nonzero(j) > 0.9 * j.size * 24 / 128
    for f in ("kscale", "vscale"):
        np.testing.assert_allclose(t[f], np.asarray(getattr(jc, f)),
                                   rtol=1e-6, atol=0)


def test_int8_decode_close_to_float_forward(int8_decode):
    """The reference test's bar: the int8 decode's last logits rank the
    forward's top token first for most sequences."""
    r, _, _, tout, _ = int8_decode
    x, _ = T.forward(r.cfg, r.params, torch.from_numpy(r.toks))
    ref = T.logits_fn(r.cfg, r.params, x)[:, -1].numpy()
    assert (ref.argmax(-1) == tout[-1].argmax(-1)).mean() >= 0.75


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["float", "int8"])
def test_merged_path_matches_reference_and_unmerged(kv_dtype):
    r = Run(kv_dtype, merged=True)
    toks = r.toks[:, :20]
    jout, _ = r.jax_decode(toks)
    n0 = K._paged_attn.launches, K._paged_attn.int8_launches
    tout, tc = r.port_decode(toks)
    for jl, tl in zip(jout, tout):
        close(jl, tl, atol=2e-5, rtol=0)
    unmerged = dataclasses.replace(r.geom, merged_attn=False)
    uout, _ = r.port_decode(toks, geom=unmerged)
    for ml, ul in zip(tout, uout):
        close(ml, ul, atol=2e-5, rtol=0)
    # the CPU launches nothing
    assert (K._paged_attn.launches, K._paged_attn.int8_launches) == n0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H,KVH,D,PS,MAXP", [
    (3, 8, 2, 32, 16, 4), (2, 4, 4, 64, 8, 5), (4, 16, 2, 128, 16, 3)])
def test_int8_plain_attention_matches_reference_dequant(dtype, B, H, KVH, D,
                                                        PS, MAXP):
    """The port's plain int8 attention against the reference's decode path
    on the same int8 pages: gather, ``dequant`` to q's dtype,
    ``paged_decode_attention``."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(B * D + H)
    NP = B * MAXP + 2
    q = (rng.randn(B, H, D) * 0.5).astype(np.float32)
    kq, ks = KC.quant_store(torch.from_numpy(
        (rng.randn(NP, KVH, PS, D) * 0.3).astype(np.float32)))
    vq, vs = KC.quant_store(torch.from_numpy(
        rng.randn(NP, KVH, PS, D).astype(np.float32)))
    ks[0, 0, 1] = 0.0                   # a zero-scale row
    lens = np.array([PS, PS + 1, MAXP * PS, 1][:B], np.int32)
    pt = np.full((B, MAXP), -1, np.int32)
    ids = rng.permutation(NP)
    c = 0
    for b in range(B):
        for p in range(-(-lens[b] // PS)):
            pt[b, p], c = ids[c], c + 1
    tq = torch.from_numpy(q).to(tdt)
    got = paged_attention_ref(tq, kq, vq, torch.from_numpy(pt),
                              torch.from_numpy(lens), kscale=ks, vscale=vs)
    assert got.dtype == tdt
    # the reference's path: per-shard gather (one shard), dequant, attend
    g = np.maximum(pt, 0)
    kg = JKC.dequant(jnp.asarray(kq.numpy()[g]), jnp.asarray(ks.numpy()[g]),
                     jdt)
    vg = JKC.dequant(jnp.asarray(vq.numpy()[g]), jnp.asarray(vs.numpy()[g]),
                     jdt)
    want = JL.paged_decode_attention(
        jnp.asarray(q, jdt)[None], kg[None], vg[None], jnp.asarray(pt)[None],
        jnp.asarray(lens)[None], PS)[0]
    tol = 2e-5 if dtype == "float32" else 6e-2
    assert float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max()) < tol


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("G,D,PS", [(1, 24, 8), (3, 64, 16), (8, 128, 16)])
def test_int8_plain_attention_equals_bf16_path_on_dequantized_pools(dtype, G,
                                                                   D, PS):
    """The plain int8 attention equals the plain attention of q's dtype on
    ``dequant``'s pools bit for bit: the int8 mode's elements are the
    dequantized ones (the card's counterpart holds the int8 kernel route
    to the bf16 mode's output bit for bit)."""
    _, tdt = DTYPES[dtype]
    rng = np.random.RandomState(G * D + PS)
    B, KVH, MAXP = 4, 2, 5
    NP = B * MAXP + 2
    q = torch.from_numpy((rng.randn(B, G * KVH, D) * 2).astype(np.float32))
    kq, ks = KC.quant_store(torch.from_numpy(
        (rng.randn(NP, KVH, PS, D) * 0.3).astype(np.float32)))
    vq, vs = KC.quant_store(torch.from_numpy(
        rng.randn(NP, KVH, PS, D).astype(np.float32)))
    lens = np.array([1, PS, 2 * PS + 1, MAXP * PS], np.int32)
    pt = np.full((B, MAXP), -1, np.int32)
    ids = rng.permutation(NP)
    for b in range(B):
        n = -(-lens[b] // PS)
        pt[b, :n] = ids[b * MAXP:b * MAXP + n]
    pt[3, 1] = -1                       # a dead page inside the length
    args = (q.to(tdt), kq, vq, torch.from_numpy(pt), torch.from_numpy(lens))
    got = paged_attention_ref(*args, kscale=ks, vscale=vs)
    want = paged_attention_ref(args[0], KC.dequant(kq, ks, tdt),
                               KC.dequant(vq, vs, tdt), *args[3:])
    assert got.dtype == tdt and torch.equal(got, want)


@pytest.fixture(scope="module")
def prefills():
    """Prefill of the same prompts: the reference int8, the port float32
    and int8; then the port's int8 decode of 8 fed tokens after it."""
    r = Run()
    _, jc = JE.prefill(r.jcfg, r.jgeom, r.jparams, jnp.asarray(r.prompt),
                       JKC.create_cache(r.jgeom))
    fgeom = KC.make_geometry(r.cfg, ShapeConfig("t", 128, 4, "decode"),
                             shards=2, page_size=16, device="cpu")
    _, fc = E.prefill(r.cfg, fgeom, r.params, torch.from_numpy(r.prompt),
                      KC.create_cache(fgeom))
    tl, tc = E.prefill(r.cfg, r.geom, r.params, torch.from_numpy(r.prompt),
                       KC.create_cache(r.geom))
    return r, jc, fc, tl, tc


def test_reference_int8_prefill_leaves_pools_zero(prefills):
    """The reference's fault, shown: its int8 prefill casts the float k/v
    into the int8 pools (|k| < 1 truncates to 0) and writes no scale."""
    r, jc, fc, _, tc = prefills
    assert float(np.abs(convert.cache_to_numpy(fc)["kpool"]).max()) > 0.1
    for f in ("kpool", "vpool", "kscale", "vscale"):
        assert np.count_nonzero(np.asarray(getattr(jc, f))) == 0, f
    # the port's first field that differs from the reference: kscale
    assert np.count_nonzero(tc.kscale.numpy()) > 0


def test_port_int8_prefill_quantizes_its_float_prefill(prefills):
    """The port's int8 prompt pages are ``quant_store`` of its float32
    prefill's pages, byte for byte; the page tables equal the
    reference's."""
    r, jc, fc, _, tc = prefills
    npages = 4 * PROMPT // 16 // 2                     # per shard
    for pools, scales, fpools in ((tc.kpool, tc.kscale, fc.kpool),
                                  (tc.vpool, tc.vscale, fc.vpool)):
        q, s = KC.quant_store(fpools[:, :, :npages])
        assert torch.equal(pools[:, :, :npages], q)
        assert torch.equal(scales[:, :, :npages], s)
        assert not pools[:, :, npages:].any()
    t = convert.cache_to_numpy(tc)
    for f in jc.table._fields:
        assert np.array_equal(np.asarray(getattr(jc.table, f)),
                              t["table"][f]), f
    for f in SMALL:
        assert np.array_equal(np.asarray(getattr(jc, f)), t[f]), f


def test_port_int8_prefill_then_decode_matches_token_by_token(prefills):
    r, _, _, tl, tc = prefills
    fed = r.toks[:, :8]
    after, _ = r.port_decode(fed, tc)
    stepwise, _ = r.port_decode(np.concatenate([r.prompt, fed], 1))
    close(stepwise[PROMPT - 1], tl.numpy())
    for a, b in zip(after, stepwise[PROMPT:]):
        close(b, a)
