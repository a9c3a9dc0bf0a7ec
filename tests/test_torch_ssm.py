"""The port's Mamba-2 SSD and the ssm family against the JAX package's, on
the CPU.

Layer cases draw their parameters from numpy seeds at scales where the
recurrent state carries a large share of the output (at the reference's
init, 0.02-scaled projections, the state's share is too small for a
float32 comparison to see); the model cases use the reference's init,
carried across by ``convert.params_from_numpy``.  Tolerances: layers
2e-5 on outputs scaled to a largest magnitude of 1 (float32 on both
sides; the gated norm's outputs reach ~16 here, where one float32 ulp is
1.9e-6), models 2e-4 / 2e-3, recurrent decode
against the reference's decode 1e-4 and against the port's own forward
3e-3 / 1e-3 (``tests/test_serving.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serving import engine as JE
from repro.serving import kvcache as JKC
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.serving import engine as E
from repro_torch.serving import kvcache as KC

LAYER_TOL = 2e-5


def strong_params(cfg, seed):
    """One layer's SSM parameters (numpy, float32) at scales where the
    state matters: decays from fast to ~0.99 per step, O(1) B, C and x."""
    s = cfg.ssm
    d_inner, nheads, conv_ch = S.ssm_dims(cfg)
    E_ = cfg.d_model
    rng = np.random.RandomState(seed)
    proj_out = 2 * d_inner + 2 * s.d_state + nheads
    return {
        "in_proj": (rng.randn(E_, proj_out) / np.sqrt(E_)).astype(np.float32),
        "conv_w": (rng.randn(s.conv_width, conv_ch) * 0.5).astype(np.float32),
        "conv_b": (rng.randn(conv_ch) * 0.1).astype(np.float32),
        "A_log": np.log(np.linspace(0.05, 2.0, nheads)).astype(np.float32),
        "D": rng.randn(nheads).astype(np.float32),
        "dt_bias": (rng.randn(nheads) * 0.5 - 1.0).astype(np.float32),
        "ssm_norm": (1.0 + 0.1 * rng.randn(d_inner)).astype(np.float32),
        "out_proj": (rng.randn(d_inner, E_) / np.sqrt(d_inner)).astype(
            np.float32),
    }


def close(got, want):
    """Within ``LAYER_TOL`` after scaling both to a largest magnitude of 1
    (or less)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy() / scale, want / scale,
                               atol=LAYER_TOL, rtol=0)


def both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("apply_out", [True, False])
@pytest.mark.parametrize("S_len", [64, 75, 32, 5])
@pytest.mark.parametrize("name", ["mamba2-370m", "hymba-1.5b"])
def test_ssd_forward_matches_reference(name, S_len, apply_out):
    """S a multiple of the chunk (32) and not (the zero-padded tail),
    with and without the out-projection (the hybrid's form)."""
    cfg = smoke_config(name)
    jp, tp = both(strong_params(cfg, S_len))
    x = np.random.RandomState(S_len + 1).randn(2, S_len, cfg.d_model).astype(
        np.float32)
    want = JS.ssd_forward(jax_smoke_config(name), jp, jnp.asarray(x),
                          apply_out=apply_out)
    got = S.ssd_forward(cfg, tp, torch.from_numpy(x), apply_out=apply_out)
    assert got.shape == want.shape
    close(got, want)


@pytest.mark.parametrize("apply_out", [True, False])
def test_ssd_decode_step_matches_reference(apply_out):
    cfg, jcfg = smoke_config("mamba2-370m"), jax_smoke_config("mamba2-370m")
    jp, tp = both(strong_params(cfg, 3))
    rng = np.random.RandomState(4)
    st = {k: rng.randn(*v.shape).astype(np.float32) for k, v in
          S.init_ssm_state(cfg, 2, device="cpu").items()}
    x = rng.randn(2, cfg.d_model).astype(np.float32)
    wy, ws = JS.ssd_decode(jcfg, jp, jnp.asarray(x),
                           {k: jnp.asarray(v) for k, v in st.items()},
                           apply_out=apply_out)
    gy, gs = S.ssd_decode(cfg, tp, torch.from_numpy(x),
                          {k: torch.from_numpy(v) for k, v in st.items()},
                          apply_out=apply_out)
    close(gy, wy)
    for k in ("S", "conv"):
        close(gs[k], ws[k])


def test_ssd_decode_equals_forward_with_strong_state():
    """The recurrence over 70 tokens equals the chunked forward (three
    chunks, the last ragged) where the state carries the output."""
    cfg = smoke_config("mamba2-370m")
    _, tp = both(strong_params(cfg, 11))
    x = torch.from_numpy(np.random.RandomState(12).randn(
        2, 70, cfg.d_model).astype(np.float32))
    want = S.ssd_forward(cfg, tp, x)
    st = S.init_ssm_state(cfg, 2, device="cpu")
    ys = []
    for t in range(x.shape[1]):
        y, st = S.ssd_decode(cfg, tp, x[:, t], st)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), want, atol=1e-4,
                               rtol=1e-4)
    # the state matters here: without it the outputs move by far more
    no_state = dict(tp, A_log=torch.full_like(tp["A_log"], 30.0))
    assert float((S.ssd_forward(cfg, no_state, x) - want).abs().max()) > 0.1


def test_ssd_forward_masks_before_exp():
    """Large log-decays (positive above the diagonal once negated) stay
    finite: the intra-chunk term is masked before the exp."""
    cfg = smoke_config("mamba2-370m")
    p = strong_params(cfg, 13)
    p["A_log"] = np.full_like(p["A_log"], 6.0)         # A = -403
    p["dt_bias"] = np.full_like(p["dt_bias"], 3.0)
    jp, tp = both(p)
    x = np.random.RandomState(14).randn(1, 40, cfg.d_model).astype(np.float32)
    got = S.ssd_forward(cfg, tp, torch.from_numpy(x))
    assert bool(got.isfinite().all())
    close(got, JS.ssd_forward(jax_smoke_config("mamba2-370m"), jp,
                              jnp.asarray(x)))


def test_ssm_params_init_distributions():
    """The port's init draws the reference's distributions: decays from
    linspace(1, 16), dt in [1e-3, 1e-1] through softplus, zero conv bias,
    unit skips and norm."""
    cfg = smoke_config("mamba2-370m")
    p = S.init_ssm_params(torch.Generator().manual_seed(0), cfg)
    jp = JS.init_ssm_params(jax.random.PRNGKey(0), jax_smoke_config(
        "mamba2-370m"))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    for k in ("A_log", "D", "conv_b", "ssm_norm"):
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0)
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert bool(((dt > 0.99e-3) & (dt < 1.01e-1)).all())


def test_mamba2_twin_forward():
    jcfg, cfg = jax_smoke_config("mamba2-370m"), smoke_config("mamba2-370m")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert "wq" not in p["blocks"] and p["blocks"]["ssm_A_log"].dtype \
        == torch.float32
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 83)).astype(
        np.int32)
    jx, _ = JT.forward(jcfg, jp, jnp.asarray(toks))
    x, aux = T.forward(cfg, p, torch.from_numpy(toks))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=2e-4,
                               rtol=2e-3)
    assert float(aux) == 0.0


@pytest.fixture(scope="module")
def recurrent():
    """40 recurrent serve_steps of the mamba2 twin on both sides (the
    reference's ``TestRecurrentDecode`` shape: batch 2, max_seq 256)."""
    jcfg, cfg = jax_smoke_config("mamba2-370m"), smoke_config("mamba2-370m")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.RandomState(6).randint(0, cfg.vocab, (2, 40)).astype(
        np.int32)
    jc = JKC.create_state_cache(jcfg, 2, 256, dtype=jnp.float32)
    tc = KC.create_state_cache(cfg, 2, 256, dtype=torch.float32, device="cpu")
    step = jax.jit(lambda p_, t, c: JE.serve_step(jcfg, None, p_, t, c))
    jl, tl = [], []
    for t in range(toks.shape[1]):
        lg, jc = step(jp, jnp.asarray(toks[:, t]), jc)
        jl.append(np.asarray(lg))
        lg, tc = E.serve_step(cfg, None, p, torch.from_numpy(toks[:, t]), tc)
        tl.append(lg)
    return cfg, p, toks, jl, jc, tl, tc


def test_recurrent_steps_match_reference(recurrent):
    cfg, _, _, jl, jc, tl, tc = recurrent
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), a, atol=1e-4, rtol=1e-4)
    got = convert.state_cache_to_numpy(tc)
    assert set(got) == set(jc)
    assert np.array_equal(got["seq_lens"], np.asarray(jc["seq_lens"]))
    for k in ("S", "conv"):
        np.testing.assert_allclose(got[k], np.asarray(jc[k]), atol=1e-5,
                                   rtol=0)


def test_recurrent_steps_equal_own_forward(recurrent):
    cfg, p, toks, _, _, tl, _ = recurrent
    x, _ = T.forward(cfg, p, torch.from_numpy(toks))
    want = T.logits_fn(cfg, p, x[:, -1])
    torch.testing.assert_close(tl[-1], want, atol=3e-3, rtol=1e-3)


def test_decode_from_carried_state_cache():
    """A state cache built by the reference's steps, carried into the port
    with ``state_cache_from_numpy``, decodes like the reference; the round
    trip gives back what went in."""
    jcfg, cfg = jax_smoke_config("mamba2-370m"), smoke_config("mamba2-370m")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(2))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.RandomState(7).randint(0, cfg.vocab, (2, 12)).astype(
        np.int32)
    jc = JKC.create_state_cache(jcfg, 2, 64, dtype=jnp.float32)
    for t in range(8):
        _, jc = JE.serve_step(jcfg, None, jp, jnp.asarray(toks[:, t]), jc)
    tc = convert.state_cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    back = convert.state_cache_to_numpy(tc)
    for k in jc:
        assert np.array_equal(back[k], np.asarray(jc[k])), k
    for t in range(8, 12):
        jl, jc = JE.serve_step(jcfg, None, jp, jnp.asarray(toks[:, t]), jc)
        tl, tc = E.serve_step(cfg, None, p, torch.from_numpy(toks[:, t]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_state_cache_shapes(dtype):
    jcfg, cfg = jax_smoke_config("mamba2-370m"), smoke_config("mamba2-370m")
    jc = JKC.create_state_cache(jcfg, 3, 50, dtype=getattr(jnp, dtype))
    tc = KC.create_state_cache(cfg, 3, 50, dtype=getattr(torch, dtype),
                               device="cpu")
    assert set(jc) == set(tc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert str(tc[k].dtype) == f"torch.{jc[k].dtype}", k
    st = S.init_ssm_state(cfg, 3, torch.bfloat16, "cpu")
    jst = JS.init_ssm_state(jcfg, 3, jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in st.items()} == {
        k: (v.shape, f"torch.{v.dtype}") for k, v in jst.items()}


def test_paged_entry_points_refuse_the_ssm_family():
    cfg = smoke_config("mamba2-370m")
    p = T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="state cache"):
        T.paged_decode_step(cfg, p, torch.zeros(2, dtype=torch.int32), None,
                            None)
    with pytest.raises(ValueError, match="state cache"):
        E.prefill(cfg, None, p, torch.zeros(2, 16, dtype=torch.int32), None)


def test_bf16_recurrent_steps_follow_reference():
    """The launcher's form: a bf16 model on a float32 state cache (the conv
    window stays float32, as the reference's promotion keeps it); logits
    within 2e-2 of the reference's over 10 steps."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in (
        jax_smoke_config("mamba2-370m"), smoke_config("mamba2-370m")))
    jp = JT.init_params(jcfg, jax.random.PRNGKey(5))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert p["blocks"]["ssm_in_proj"].dtype == torch.bfloat16
    assert p["blocks"]["ssm_conv_b"].dtype == torch.float32
    toks = np.random.RandomState(8).randint(0, cfg.vocab, (2, 10)).astype(
        np.int32)
    jc = JKC.create_state_cache(jcfg, 2, 32, dtype=jnp.float32)
    tc = KC.create_state_cache(cfg, 2, 32, dtype=torch.float32, device="cpu")
    for t in range(toks.shape[1]):
        jl, jc = JE.serve_step(jcfg, None, jp, jnp.asarray(toks[:, t]), jc)
        tl, tc = E.serve_step(cfg, None, p, torch.from_numpy(toks[:, t]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-2,
                                   rtol=0)
    assert tc["conv"].dtype == torch.float32


@pytest.mark.parametrize("name", ["mamba2-370m", "hymba-1.5b"])
def test_launcher_stepper_on_cpu_is_serve_step(name):
    """On a CPU state cache the launcher's step is ``serve_step`` itself
    (the CUDA graph is the card's alone): 12 steps equal bit for bit."""
    from repro_torch.launch import serve
    cfg = smoke_config(name)
    p = T.init_params(cfg, torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    a = serve.make_state_cache(cfg, 2, 12, 0, device="cpu")
    b = serve.make_state_cache(cfg, 2, 12, 0, device="cpu")
    step = serve.stepper(cfg, None, p, a)
    assert not isinstance(step, serve.GraphedStep)
    for t in range(toks.shape[1]):
        got, a = step(toks[:, t], a)
        want, b = E.serve_step(cfg, None, p, toks[:, t], b)
        assert torch.equal(got, want)
    for k in b:
        assert torch.equal(a[k], b[k]), k
