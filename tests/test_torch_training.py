"""The port's training path against the JAX package's, on the CPU.

Every family's smoke config (float32) with the JAX package's weights
carried across as float32 masters (``params_from_numpy(...,
master_dtype=float32)``); batches of tokens, or (B, S, E) embeddings for
the embedding frontends, made with numpy from seeds.

Tolerances: ``loss_fn`` within 1e-5 relative (float32 on both sides, only
the order of sums differs); each gradient leaf within 1e-4 of that leaf's
largest |g| (``jax.grad``); ``apply_updates`` within 1e-6 of each leaf's
largest value (the same float32 arithmetic in the same order); the
schedule equal; ten steps' losses within 1e-3 relative of the
reference's (Adam divides each gradient by its running scale, so the
last bits of near-zero gradients move an update by up to lr); the
microbatch, clipping, bf16-accumulation and learning bars of
``tests/test_training.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro.training.train_step import make_train_step as jax_train_step
from repro.training.train_step import microbatch_grads as jax_micro
from repro_torch import convert
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as O
from repro_torch.training.train_step import make_train_step, microbatch_grads

F32 = torch.float32


def model(name, seed=0):
    jcfg, cfg = jax_smoke_config(name), smoke_config(name)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, convert.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, "cpu", master_dtype=F32)


def batch(cfg, B=4, S=64, seed=1):
    """{"inputs", "labels"} as numpy: tokens (or embeddings) and the
    tokens shifted by one."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    inputs = (rng.randn(B, S, cfg.d_model).astype(np.float32)
              if cfg.frontend == "embed" else toks)
    return {"inputs": inputs, "labels": np.roll(toks, -1, 1)}


def jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def flat(tree):
    """{dotted path: numpy} of a port tree or a JAX tree (dicts)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update({f"{k}.{p}": a for p, a in flat(v).items()})
        else:
            out[k] = (v.detach().float().numpy().copy()
                      if isinstance(v, torch.Tensor)
                      else np.array(v, np.float32))
    return out


_GRADS = {}


def grads_of(name):
    """(reference (loss, grads), port (loss, grads)) of one family, kept
    for the module."""
    if name not in _GRADS:
        jcfg, cfg, jp, p = model(name)
        b = batch(cfg, B=2, S=48)
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p_, b_: JT.loss_fn(jcfg, p_, b_)))(jp, jb(b))
        tl, tg = microbatch_grads(cfg, p, tb(b), 1, F32)
        _GRADS[name] = ((float(jl), flat(jg)), (float(tl), flat(tg)))
    return _GRADS[name]


def test_archs_are_the_references():
    assert list(ARCHS) == list(JARCHS)


@pytest.mark.parametrize("name", list(ARCHS))
def test_loss_matches_reference(name):
    (jl, _), (tl, _) = grads_of(name)
    assert np.isfinite(tl) and abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)


@pytest.mark.parametrize("name", list(ARCHS))
def test_gradients_match_jax_grad(name):
    (_, jg), (_, tg) = grads_of(name)
    assert sorted(jg) == sorted(tg)
    for k, want in jg.items():
        got = tg[k]
        assert got.shape == want.shape, k
        limit = 1e-4 * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= limit, k


def opt_case(seed=0):
    """Parameters, gradients and a state at step 3 (numpy), with a 1-d
    leaf (no weight decay) and 2-d and 3-d ones."""
    rng = np.random.RandomState(seed)
    shapes = {"embed": (16, 8), "blocks": {"wq": (2, 8, 8), "ln1": (2, 8)},
              "final_scale": (8,)}

    def tree(scale, positive=False):
        def leaf(s):
            a = rng.randn(*s).astype(np.float32) * scale
            return np.abs(a) if positive else a
        return {k: ({n: leaf(s) for n, s in v.items()} if isinstance(v, dict)
                    else leaf(v)) for k, v in shapes.items()}
    return (tree(0.1), tree(0.5), tree(0.01), tree(1e-3, positive=True),
            np.int32(3))


def as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("clip", [1.0, 1e-3])
def test_apply_updates_matches_reference(clip):
    params, grads, m, v, step = opt_case()
    ocfg = dict(lr=1e-2, warmup=2, decay_steps=50, grad_clip=clip)
    jp, js, jstats = JO.apply_updates(
        JO.OptConfig(**ocfg), as_jax(params), as_jax(grads),
        JO.OptState(as_jax(m), as_jax(v), jnp.asarray(step)))
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    ts = convert.opt_state_from_numpy(JO.OptState(m, v, step), "cpu")
    tp, ts, tstats = O.apply_updates(O.OptConfig(**ocfg), tp,
                                     jax.tree.map(torch.from_numpy, grads),
                                     ts)
    assert int(ts.step) == 4 and ts.step.dtype == torch.int32
    for name, jt, tt in (("p", jp, tp), ("m", js.m, ts.m), ("v", js.v, ts.v)):
        want, got = flat(jt), flat(tt)
        for k in want:
            np.testing.assert_allclose(
                got[k], want[k], rtol=0,
                atol=1e-6 * float(np.abs(want[k]).max()), err_msg=name + k)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-6)
    # the port's state carried back equals the reference's layout
    back = convert.opt_state_to_numpy(ts)
    assert back["step"].dtype == np.int32 and int(back["step"]) == 4
    assert sorted(flat(back["m"])) == sorted(flat(js.m))
    assert sorted(flat(convert.params_to_numpy(tp))) == sorted(flat(jp))


def test_schedule_equals_reference():
    ocfg = dict(lr=1.0, warmup=10, decay_steps=110)
    for s in [0, 5, 10, 60, 110, 1000]:
        want = np.float32(JO.schedule(JO.OptConfig(**ocfg), s))
        got = O.schedule(O.OptConfig(**ocfg), s)
        assert got.dtype == F32 and np.float32(got) == want, (s, got, want)
        got_t = O.schedule(O.OptConfig(**ocfg),
                           torch.tensor(s, dtype=torch.int32))
        want_t = np.float32(JO.schedule(JO.OptConfig(**ocfg),
                                        jnp.asarray(s, jnp.int32)))
        assert np.float32(got_t) == want_t, s


def test_grad_clip():
    """The reference's bar: a clip of 1e-6 moves no weight by 1e-3."""
    _, cfg, _, p = model("yi-6b")
    b = tb(batch(cfg))
    before = flat(p)
    _, grads = microbatch_grads(cfg, p, b, 1, F32)
    p, _, stats = O.apply_updates(O.OptConfig(lr=1e-3, grad_clip=1e-6), p,
                                  grads, O.init(p))
    after = flat(p)
    assert max(float(np.abs(after[k] - before[k]).max())
               for k in before) < 1e-3
    assert float(stats["grad_norm"]) > 1e-3


def test_microbatch_one_against_four():
    jcfg, cfg, jp, p = model("yi-6b")
    b = batch(cfg)
    l1, g1 = microbatch_grads(cfg, p, tb(b), 1, F32)
    l4, g4 = microbatch_grads(cfg, p, tb(b), 4, F32)
    assert abs(float(l1) - float(l4)) < 2e-2
    f1, f4 = flat(g1), flat(g4)
    for k in f1:
        np.testing.assert_allclose(f4[k], f1[k], atol=2e-3, rtol=2e-2)
    # and the four-way accumulation against the reference's
    jl4, jg4 = jax_micro(jcfg, jp, jb(b), 4, jnp.float32)
    assert abs(float(l4) - float(jl4)) <= 1e-5 * abs(float(jl4))
    for k, want in flat(jg4).items():
        assert float(np.abs(f4[k] - want).max()) <= \
            1e-4 * float(np.abs(want).max()), k


def test_grad_compression_bf16_close():
    _, cfg, _, p = model("yi-6b")
    b = tb(batch(cfg))
    _, g32 = microbatch_grads(cfg, p, b, 2, F32)
    _, g16 = microbatch_grads(cfg, p, b, 2, torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 for _, g in O.leaves(g16))
    n32, n16 = float(O.global_norm(g32)), float(O.global_norm(g16))
    assert abs(n32 - n16) / n32 < 0.05


@pytest.mark.parametrize("name", ["yi-6b", "granite-moe-1b-a400m",
                                  "mamba2-370m", "hymba-1.5b"])
def test_remat_modes_give_equal_gradients(name):
    _, cfg, _, p = model(name)
    b = tb(batch(cfg, B=2, S=48))
    out = {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = microbatch_grads(c, p, b, 1, F32)
    l0, g0 = out["none"]
    for remat in ("full", "dots"):
        l, g = out[remat]
        assert torch.equal(l, l0), remat
        for (k, a), (_, c) in zip(O.leaves(g0), O.leaves(g)):
            assert torch.equal(a, c), (remat, k)


def test_ten_steps_track_reference_and_learn():
    jcfg, cfg, jp, p = model("yi-6b")
    b = batch(cfg)
    ocfg = dict(lr=1e-3, warmup=2, decay_steps=100)
    jstep = jax.jit(jax_train_step(jcfg, JO.OptConfig(**ocfg)))
    tstep = make_train_step(cfg, O.OptConfig(**ocfg))
    js, ts = JO.init(jp), O.init(p)
    jl, tl = [], []
    for _ in range(10):
        jp, js, jstats = jstep(jp, js, jb(b))
        p, ts, tstats = tstep(p, ts, tb(b))
        jl.append(float(jstats["loss"]))
        tl.append(float(tstats["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0] - 0.3
    assert int(ts.step) == 10
