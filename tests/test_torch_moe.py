"""The port's MoE layer and the moe family against the JAX package's, on
the CPU.

Inputs are numpy from seeds; the JAX side runs on the CPU; weights go
across with ``convert.params_from_numpy``.  Tolerances: top-k ids, the
sorted dispatch's order, ranks and keep masks exact; layer outputs and
the load-balance ``aux`` within 2e-5 (float32 on both sides); models
within 2e-4 / 2e-3 (``tests/test_models.py``); paged decode against the
port's own forward within 3e-3 / 1e-3 (``tests/test_serving.py``), with
a capacity at which no token drops (the reference's capacity drops
depend on how many tokens share a call, so decode and forward differ
legitimately at 1.25); page-table fields byte-equal.
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
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeConfig
from repro_torch.serving import engine as E
from repro_torch.serving import kvcache as KC

SMALL = ("next_free", "seq_ids", "seq_lens", "cur_page", "cur_off")


def configs(name, **moe):
    """(JAX config, port config) of ``name``'s twin with MoE fields set."""
    jc, tc = jax_smoke_config(name), smoke_config(name)
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


def layer_params(rng, cfg, scale=0.1):
    m, E = cfg.moe, cfg.d_model
    shapes = {"router": (E, m.num_experts),
              "we_gate": (m.num_experts, E, m.expert_dff),
              "we_up": (m.num_experts, E, m.expert_dff),
              "we_down": (m.num_experts, m.expert_dff, E)}
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def reference_dispatch(cfg, p, xt):
    """The reference's routing and sorted dispatch plan, in jnp (the
    expressions of ``repro.models.layers.moe``)."""
    m = cfg.moe
    T_, K = xt.shape[0], m.top_k
    logits = jnp.einsum("te,en->tn", xt, p["router"])
    topv, topi = jax.lax.top_k(logits, K)
    gates = jax.nn.softmax(topv, axis=-1)
    eid = topi.reshape(T_ * K)
    order = jnp.argsort(eid)
    se = eid[order]
    st = jnp.repeat(jnp.arange(T_), K)[order]
    pos = jnp.arange(T_ * K) - jnp.searchsorted(se, se, side="left")
    cap = int(np.ceil(T_ * K / m.num_experts * m.capacity_factor))
    return (np.asarray(logits), np.asarray(topi), np.asarray(gates),
            np.asarray(se), np.asarray(st), np.asarray(pos),
            np.asarray(pos < cap), cap)


@pytest.mark.parametrize("capacity", [0.5, 1.0, 1.25, 4.0])
@pytest.mark.parametrize("impl", ["sorted", "dense"])
@pytest.mark.parametrize("name", ["granite-moe-1b-a400m",
                                  "granite-moe-3b-a800m"])
def test_moe_layer_matches_reference(name, impl, capacity):
    """Top-k ids and the dispatch plan exact, outputs and aux within 2e-5;
    at capacity 0.5 and 1.0 the sorted dispatch drops assignments."""
    jc, tc = configs(name, impl=impl, capacity_factor=capacity)
    rng = np.random.RandomState(int(capacity * 8) + len(name))
    p = layer_params(rng, tc)
    x = rng.randn(3, 21, tc.d_model).astype(np.float32)
    xt = x.reshape(-1, tc.d_model)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want_out, want_aux = JL.moe(jc, {k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x))
    got_out, got_aux = TL.moe(tc, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=2e-5,
                               rtol=0)

    logits, topi, gates, se, st, pos, keep, cap = reference_dispatch(
        jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(xt))
    t_logits, t_topi, t_gates = TL.moe_route(tc, tp, torch.from_numpy(xt))
    assert np.array_equal(t_topi.numpy(), topi)
    np.testing.assert_allclose(t_logits.numpy(), logits, atol=2e-5, rtol=0)
    np.testing.assert_allclose(t_gates.numpy(), gates, atol=2e-5, rtol=0)
    t_se, t_st, _, t_pos, t_keep, t_cap = TL.moe_dispatch(tc, t_topi, t_gates)
    assert t_cap == cap
    for got, want in ((t_se, se), (t_st, st), (t_pos, pos), (t_keep, keep)):
        assert np.array_equal(got.numpy(), want)
    if impl == "sorted" and capacity <= 1.0:
        assert not keep.all()              # the case drops assignments


@pytest.mark.parametrize("capacity", [0.5, 4.0])
@pytest.mark.parametrize("name", ["granite-moe-1b-a400m",
                                  "granite-moe-3b-a800m"])
def test_sorted_combine_adds_in_the_reference_order(name, capacity):
    """The sorted dispatch's combine adds each token's contributions in the
    dispatch's sorted order (its experts in ascending id), with no atomics:
    on the same contributions it equals the reference's ``out.at[st].add``
    bit for bit, and two calls of the layer give the same bits."""
    jc, tc = configs(name, capacity_factor=capacity)
    rng = np.random.RandomState(11)
    p = {k: torch.from_numpy(v) for k, v in layer_params(rng, tc).items()}
    x = torch.from_numpy(rng.randn(2, 19, tc.d_model).astype(np.float32))
    (a, aux_a), (b, aux_b) = TL.moe(tc, p, x), TL.moe(tc, p, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    _, topi, gates = TL.moe_route(tc, p, x.reshape(-1, tc.d_model))
    st = TL.moe_dispatch(tc, topi, gates)[1]
    T_, E_ = topi.shape[0], tc.d_model
    # contributions of widely spread magnitudes: any other order of the
    # additions changes low bits
    contrib = (rng.randn(st.numel(), E_)
               * np.exp(rng.randn(st.numel(), 1) * 3)).astype(np.float32)
    got = TL._moe_combine(torch.from_numpy(contrib), st, T_)
    want = jnp.zeros((T_, E_), jnp.float32).at[jnp.asarray(st.numpy())].add(
        jnp.asarray(contrib))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_dense_equals_sorted_without_drops():
    """The two implementations agree when nothing drops (the reference's
    ``test_dense_moe_equals_sorted``), on the port alone."""
    _, ts = configs("granite-moe-1b-a400m", capacity_factor=8.0)
    td = dataclasses.replace(ts, moe=dataclasses.replace(ts.moe,
                                                         impl="dense"))
    rng = np.random.RandomState(5)
    p = {k: torch.from_numpy(v) for k, v in layer_params(rng, ts).items()}
    x = torch.from_numpy(rng.randn(2, 17, ts.d_model).astype(np.float32))
    (a, aux_a), (b, aux_b) = TL.moe(ts, p, x), TL.moe(td, p, x)
    torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
    torch.testing.assert_close(aux_a, aux_b, atol=1e-6, rtol=0)


def test_router_stays_float32_in_bf16():
    """A bf16 model keeps its router in float32 (a bf16 router flips top-k
    choices) and its expert matrices in bf16; its layer matches the
    reference's in bf16 (top-k exact on these inputs)."""
    jc, tc = configs("granite-moe-3b-a800m")
    jc, tc = (dataclasses.replace(c, dtype="bfloat16") for c in (jc, tc))
    jp = JT.init_params(jc, jax.random.PRNGKey(3))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    assert p["blocks"]["router"].dtype == torch.float32
    assert p["blocks"]["we_gate"].dtype == torch.bfloat16
    assert p["embed"].dtype == torch.float32          # tied: the LM head
    lp = T.layer_params(p, 0)
    jlp = jax.tree.map(lambda a: a[0], jp["blocks"])
    x = np.random.RandomState(4).randn(2, 9, tc.d_model).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, _ = JL.moe(jc, jlp, xb)
    got, _ = TL.moe(tc, lp, torch.from_numpy(x).to(torch.bfloat16))
    _, want_i = jax.lax.top_k(jnp.einsum("te,en->tn", xb.reshape(-1, 128)
                                         .astype(jnp.float32),
                                         jlp["router"]), tc.moe.top_k)
    _, got_i, _ = TL.moe_route(tc, lp, torch.from_numpy(x).to(
        torch.bfloat16).reshape(-1, 128))
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=0)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m",
                                  "granite-moe-3b-a800m"])
def test_moe_twin_forward(name):
    jc, tc = configs(name)
    jp = JT.init_params(jc, jax.random.PRNGKey(1))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    toks = np.random.RandomState(9).randint(0, tc.vocab, (2, 75)).astype(
        np.int32)
    jx, jaux = JT.forward(jc, jp, jnp.asarray(toks))
    x, aux = T.forward(tc, p, torch.from_numpy(toks))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=2e-4,
                               rtol=2e-3)
    np.testing.assert_allclose(float(aux), float(jaux), atol=2e-5, rtol=0)


class Paged:
    """The granite-moe-3b twin served on both sides through the paged
    path (page size 16, 2 shards, batch 4)."""

    def __init__(self, **moe):
        self.jcfg, self.cfg = configs("granite-moe-3b-a800m", **moe)
        self.jparams = JT.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.params = convert.params_from_numpy(
            jax.tree.map(np.asarray, self.jparams), self.cfg, "cpu")
        shape = dict(seq_len=128, global_batch=4, kind="decode")
        self.jgeom = JKC.make_geometry(self.jcfg, JShape("t", **shape),
                                       shards=2, page_size=16)
        self.geom = KC.make_geometry(self.cfg, ShapeConfig("t", **shape),
                                     shards=2, page_size=16, device="cpu")
        rng = np.random.RandomState(2)
        self.prompt = rng.randint(0, self.cfg.vocab, (4, 32)).astype(np.int32)
        self.fed = rng.randint(0, self.cfg.vocab, (4, 12)).astype(np.int32)


def assert_same_cache(jc, tc):
    t = convert.cache_to_numpy(tc)
    for f in jc.table._fields:
        assert np.array_equal(np.asarray(getattr(jc.table, f)),
                              t["table"][f]), f
    for f in SMALL:
        assert np.array_equal(np.asarray(getattr(jc, f)), t[f]), f
    for f in ("kpool", "vpool"):
        np.testing.assert_allclose(t[f], np.asarray(getattr(jc, f)),
                                   atol=1e-5, rtol=0)


def test_moe_twin_paged_prefill_and_decode():
    """Prefill and 12 decode steps of the moe twin against the reference's
    serve path: logits within 1e-4, page tables byte-equal; the decode
    step runs the MoE at B 4 (cap ceil(4·2/8·1.25) = 2: drops happen)."""
    r = Paged()
    jl, jc = JE.prefill(r.jcfg, r.jgeom, r.jparams, jnp.asarray(r.prompt),
                        JKC.create_cache(r.jgeom))
    tl, tc = E.prefill(r.cfg, r.geom, r.params, torch.from_numpy(r.prompt),
                       KC.create_cache(r.geom))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    assert_same_cache(jc, tc)
    jstep = jax.jit(lambda p, t, c: JE.serve_step(r.jcfg, r.jgeom, p, t, c))
    for i in range(r.fed.shape[1]):
        jl, jc = jstep(r.jparams, jnp.asarray(r.fed[:, i]), jc)
        tl, tc = E.serve_step(r.cfg, r.geom, r.params,
                              torch.from_numpy(r.fed[:, i]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    assert_same_cache(jc, tc)
    jc = JE.release_sequence(r.jgeom, jc, 1, 0)
    tc = E.release_sequence(r.geom, tc, 1, 0)
    assert_same_cache(jc, tc)


def test_moe_twin_decode_equals_own_forward():
    """With a capacity at which nothing drops (num_experts / top_k), paged
    decode's logits equal the port's own dense forward over the same
    tokens (3e-3 / 1e-3)."""
    r = Paged(capacity_factor=4.0)
    tl, tc = E.prefill(r.cfg, r.geom, r.params, torch.from_numpy(r.prompt),
                       KC.create_cache(r.geom))
    for i in range(r.fed.shape[1]):
        tl, tc = E.serve_step(r.cfg, r.geom, r.params,
                              torch.from_numpy(r.fed[:, i]), tc)
    hist = torch.from_numpy(np.concatenate([r.prompt, r.fed], 1))
    x, _ = T.forward(r.cfg, r.params, hist)
    want = T.logits_fn(r.cfg, r.params, x[:, -1])
    torch.testing.assert_close(tl, want, atol=3e-3, rtol=1e-3)

