"""The port's hybrid family (hymba: parallel attention and SSM heads,
sliding-window layers with full attention at {0, L//2, L-1}) against the
JAX package's, on the CPU.

Weights are the reference's init, carried across by
``convert.params_from_numpy``; tokens are numpy from seeds.  Tolerances:
``layer_segments`` exact; models 2e-4 / 2e-3 (``tests/test_models.py``);
recurrent decode against the reference's decode 1e-4 per step, against
the port's own forward 3e-3 / 1e-3 (``tests/test_serving.py``); state
caches (ring and global caches, SSM state, conv windows) within 1e-5,
``seq_lens`` exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.serving import engine as JE
from repro.serving import kvcache as JKC
from repro_torch import convert
from repro_torch.configs import get_arch, smoke_config
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving import engine as E
from repro_torch.serving import kvcache as KC

STEPS = 100                    # past the twin's 64-token window


@pytest.mark.parametrize("n_layers", range(1, 41))
def test_layer_segments(n_layers):
    from repro.configs import get_arch as jax_get_arch
    jcfg = dataclasses.replace(jax_get_arch("hymba-1.5b"), n_layers=n_layers)
    cfg = dataclasses.replace(get_arch("hymba-1.5b"), n_layers=n_layers)
    segs = T.layer_segments(cfg)
    assert segs == JT.layer_segments(jcfg)
    windows = T.layer_windows(cfg)
    assert len(windows) == n_layers
    glob = {0, n_layers // 2, n_layers - 1}
    assert [i for i, w in enumerate(windows) if w == 0] == sorted(glob)
    assert all(w == cfg.window for i, w in enumerate(windows)
               if i not in glob)


def test_non_hybrid_families_are_one_segment():
    for name in ("yi-6b", "granite-moe-3b-a800m", "mamba2-370m"):
        cfg = get_arch(name)
        assert T.layer_segments(cfg) == [(0, cfg.n_layers, cfg.window)]


def model(seed=0, **updates):
    jcfg = dataclasses.replace(jax_smoke_config("hymba-1.5b"), **updates)
    cfg = dataclasses.replace(smoke_config("hymba-1.5b"), **updates)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, convert.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, "cpu")


def test_hymba_params_match_reference_tree():
    """Hybrid blocks: no ``wo`` and no ``ssm_out_proj``; the fused
    projection and its two scales; storage dtypes of a bf16 model."""
    jcfg, cfg, jp, p = model(dtype="bfloat16")
    assert set(p["blocks"]) == set(jp["blocks"])
    assert "wo" not in p["blocks"] and "ssm_out_proj" not in p["blocks"]
    for k, v in p["blocks"].items():
        assert tuple(v.shape) == jp["blocks"][k].shape, k
    assert p["blocks"]["w_fuse"].dtype == torch.bfloat16
    for k in ("fuse_attn_scale", "fuse_ssm_scale", "ssm_A_log", "ssm_D",
              "ssm_dt_bias", "ssm_ssm_norm", "ssm_conv_b"):
        assert p["blocks"][k].dtype == torch.float32, k
    own = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own["blocks"].items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in p["blocks"].items()}


@pytest.mark.parametrize("S_len", [100, 64, 37])
def test_hymba_twin_forward(S_len):
    """Banded window attention (window 64, chunk 64), the full-attention
    layers and the chunked SSD together, against the reference."""
    jcfg, cfg, jp, p = model()
    toks = np.random.RandomState(S_len).randint(0, cfg.vocab, (2, S_len)
                                                ).astype(np.int32)
    jx, _ = JT.forward(jcfg, jp, jnp.asarray(toks))
    x, _ = T.forward(cfg, p, torch.from_numpy(toks))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=2e-4,
                               rtol=2e-3)


def test_hymba_twin_forward_causal_skip_and_small_window():
    """The twin with a 16-token window over chunks of 16 and the
    causal-skip mode on its full-attention layers."""
    jcfg, cfg, jp, p = model(window=16, attn_chunk=16,
                             attn_mode="causal_skip")
    toks = np.random.RandomState(3).randint(0, cfg.vocab, (2, 70)).astype(
        np.int32)
    jx, _ = JT.forward(jcfg, jp, jnp.asarray(toks))
    x, _ = T.forward(cfg, p, torch.from_numpy(toks))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=2e-4,
                               rtol=2e-3)


@pytest.fixture(scope="module")
def recurrent():
    """100 recurrent serve_steps of the hymba twin on both sides (the
    reference's ``TestRecurrentDecode`` shape: batch 2, max_seq 256)."""
    jcfg, cfg, jp, p = model()
    toks = np.random.RandomState(6).randint(0, cfg.vocab, (2, STEPS)).astype(
        np.int32)
    jc = JKC.create_state_cache(jcfg, 2, 256, dtype=jnp.float32)
    tc = KC.create_state_cache(cfg, 2, 256, dtype=torch.float32, device="cpu")
    step = jax.jit(lambda p_, t, c: JE.serve_step(jcfg, None, p_, t, c))
    jl, tl = [], []
    for t in range(STEPS):
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
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(jc[k]), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_recurrent_steps_equal_own_forward(recurrent):
    """Past the window every ring has wrapped; the last step's logits equal
    the port's forward (banded window attention, chunked SSD)."""
    cfg, p, toks, _, _, tl, _ = recurrent
    x, _ = T.forward(cfg, p, torch.from_numpy(toks))
    want = T.logits_fn(cfg, p, x)
    for t in (cfg.window - 1, cfg.window, STEPS - 1):
        torch.testing.assert_close(tl[t], want[:, t], atol=3e-3, rtol=1e-3)


def test_ring_holds_the_last_window(recurrent):
    """Each windowed layer's ring holds the last ``window`` tokens at slot
    ``position % window``: the k cached at the last step sits at its
    slot."""
    cfg, p, toks, _, _, _, tc = recurrent
    W = cfg.window
    slot = (STEPS - 1) % W
    assert int(tc["seq_lens"][0]) == STEPS
    n_win = sum(1 for w in T.layer_windows(cfg) if w)
    assert tc["ring_k"].shape[:3] == (n_win, 2, W)
    # the global layers' linear caches hold every position up to STEPS
    assert bool(tc["glob_k"][:, :, :STEPS].abs().sum(-1).gt(0).all())
    assert not bool(tc["glob_k"][:, :, STEPS:].any())
    assert bool(tc["ring_k"][:, :, slot].abs().sum(-1).gt(0).all())


def test_shifted_ring_slot_breaks_decode():
    """A ring written one slot off drops the newest token from the window
    until the ring wraps: the step's logits leave the forward's."""
    jcfg, cfg, jp, p = model()
    toks = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab, (2, 40)).astype(np.int32))
    x, _ = T.forward(cfg, p, toks)
    want = T.logits_fn(cfg, p, x[:, -1])
    slot = T.ring_slot
    T.ring_slot = lambda seq_lens, window: (seq_lens + 1) % window
    try:
        lg, _ = serve.run_prefill(cfg, None, p, toks,
                                  serve.make_state_cache(cfg, 2, 40, 0,
                                                         device="cpu"))
    finally:
        T.ring_slot = slot
    assert float((lg - want).abs().max()) > 3e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_state_cache_shapes(dtype):
    jcfg, cfg = jax_smoke_config("hymba-1.5b"), smoke_config("hymba-1.5b")
    jc = JKC.create_state_cache(jcfg, 3, 90, dtype=getattr(jnp, dtype))
    tc = KC.create_state_cache(cfg, 3, 90, dtype=getattr(torch, dtype),
                               device="cpu")
    assert set(jc) == set(tc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert str(tc[k].dtype) == f"torch.{jc[k].dtype}", k


def test_full_hymba_state_cache_geometry():
    """At full width: 29 windowed layers of 1,024-slot rings, 3 global
    linear caches, 32 SSM states of (25 heads, 16, 64)."""
    cfg = get_arch("hymba-1.5b")
    c = KC.create_state_cache(cfg, 1, 8,
                              dtype=torch.float32, device="meta")
    assert tuple(c["ring_k"].shape) == (29, 1, 1024, 5, 64)
    assert tuple(c["glob_k"].shape) == (3, 1, 8, 5, 64)
    assert tuple(c["S"].shape) == (32, 1, 25, 16, 64)
    assert tuple(c["conv"].shape) == (32, 1, 3, 1632)


def test_launcher_runs_the_hybrid_and_ssm_twins(capsys):
    for arch in ("hymba-1.5b", "mamba2-370m"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                    "2", "--prompt-len", "8", "--gen", "4"])
        out = capsys.readouterr().out
        assert f"arch={smoke_config(arch).name}" in out
        assert "page table" not in out
