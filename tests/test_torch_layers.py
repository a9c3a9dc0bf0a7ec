"""The port's transformer layers against the JAX package's, on the CPU.

The same numpy inputs (from seeds) go through ``repro.models.layers`` and
``repro_torch.models.layers`` in float32; outputs agree within 1e-5
(both sides compute in float32; only the order of the sums differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro_torch.configs import smoke_config
from repro_torch.models import layers as TL

ATOL = 1e-5


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().numpy().astype(np.float32),
                               atol=atol, rtol=0)


def randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def test_norms():
    rng = np.random.RandomState(0)
    x, sc, b = randn(rng, 3, 5, 64), randn(rng, 64), randn(rng, 64)
    t = torch.from_numpy
    close(JL.rmsnorm(jnp.asarray(x), jnp.asarray(sc)), TL.rmsnorm(t(x), t(sc)))
    close(JL.layernorm(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(b)),
          TL.layernorm(t(x), t(sc), t(b)))


@pytest.mark.parametrize("theta", [10000.0, 5e6])
def test_rope(theta):
    rng = np.random.RandomState(1)
    x = randn(rng, 2, 37, 4, 32)
    pos = np.arange(37)[None].repeat(2, 0) + np.array([[0], [1000]])
    close(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta),
          TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta))
    # the decode form: (B, H, D) with (B,) positions
    close(JL.rope(jnp.asarray(x[:, 0]), jnp.asarray(pos[:, 5]), theta),
          TL.rope(torch.from_numpy(x[:, 0]), torch.from_numpy(pos[:, 5]),
                  theta))


@pytest.mark.parametrize("S,chunk,KVH,q_offset", [(40, 16, 1, 0),
                                                  (64, 64, 2, 0),
                                                  (33, 8, 4, 5)])
def test_blockwise_attention(S, chunk, KVH, q_offset):
    rng = np.random.RandomState(S)
    B, H, D = 2, 8, 16
    q = randn(rng, B, S, H, D)
    k = randn(rng, B, S + q_offset, KVH, D)
    v = randn(rng, B, S + q_offset, KVH, D)
    want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), chunk=chunk,
                                  q_offset=q_offset)
    got = TL.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), chunk=chunk,
                                 q_offset=q_offset)
    close(want, got)


def test_decode_and_paged_decode_attention():
    rng = np.random.RandomState(3)
    DS, Bl, H, KVH, D, MAXP, PS = 2, 3, 8, 2, 16, 4, 8
    q = randn(rng, DS, Bl, H, D)
    kg = randn(rng, DS, Bl, MAXP, KVH, PS, D)
    vg = randn(rng, DS, Bl, MAXP, KVH, PS, D)
    lens = rng.randint(1, MAXP * PS, size=(DS, Bl)).astype(np.int32)
    pt = np.where(np.arange(MAXP)[None, None] * PS < lens[..., None],
                  rng.randint(0, 50, size=(DS, Bl, MAXP)), -1).astype(np.int32)
    pt[0, 1, 1] = -1                      # an unmapped page inside the length
    want = JL.paged_decode_attention(*map(jnp.asarray, (q, kg, vg, pt, lens)),
                                     PS)
    got = TL.paged_decode_attention(*map(torch.from_numpy, (q, kg, vg, pt,
                                                            lens)), PS)
    close(want, got)
    # decode_attention over a linear (B, T, KVH, D) cache
    k, v = kg[0].reshape(Bl, MAXP * PS, KVH, D), vg[0].reshape(Bl, -1, KVH, D)
    want = JL.decode_attention(*map(jnp.asarray, (q[0], k, v, lens[0])))
    got = TL.decode_attention(*map(torch.from_numpy, (q[0], k, v, lens[0])))
    close(want, got)


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_mlp(mlp):
    import dataclasses
    cfg = dataclasses.replace(smoke_config("yi-6b"), mlp=mlp)
    jcfg = dataclasses.replace(jax_smoke_config("yi-6b"), mlp=mlp)
    rng = np.random.RandomState(4)
    x = randn(rng, 5, cfg.d_model)
    p = {k: randn(rng, *s, scale=0.1) for k, s in (
        ("w_gate", (cfg.d_model, cfg.d_ff)), ("w_up", (cfg.d_model, cfg.d_ff)),
        ("w_down", (cfg.d_ff, cfg.d_model)))}
    close(JL.mlp(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                 jnp.asarray(x)),
          TL.mlp(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x)))


# (S, T extra keys before q (q_offset), chunk, window, KVH): ragged S,
# windows below, at and above the chunk, a band wider than the keys
WINDOW_CASES = [(40, 0, 16, 8, 2), (40, 0, 16, 16, 1), (64, 0, 16, 24, 2),
                (33, 5, 8, 12, 4), (50, 7, 16, 64, 2), (96, 0, 32, 40, 1),
                (17, 3, 64, 4, 2)]


@pytest.mark.parametrize("S,q_offset,chunk,window,KVH", WINDOW_CASES)
def test_window_attention(S, q_offset, chunk, window, KVH):
    """The banded sliding-window branch against the reference's, with the
    same clamped band start at the sequence's edges (2e-4 / 2e-3, as
    ``tests/test_models.py`` holds the model-level window)."""
    rng = np.random.RandomState(100 + S + window)
    B, H, D = 2, 8, 16
    q = randn(rng, B, S, H, D)
    k = randn(rng, B, S + q_offset, KVH, D)
    v = randn(rng, B, S + q_offset, KVH, D)
    want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), chunk=chunk, window=window,
                                  q_offset=q_offset)
    got = TL.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), chunk=chunk,
                                 window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-3)


def test_window_attention_masks_distant_keys():
    """Keys at or beyond ``window`` positions back do not reach an output:
    poisoning them leaves it unchanged."""
    rng = np.random.RandomState(7)
    S, W = 48, 8
    q, k, v = (torch.from_numpy(randn(rng, 1, S, 4, 16)) for _ in range(3))
    base = TL.blockwise_attention(q, k, v, chunk=16, window=W)
    k2, v2 = k.clone(), v.clone()
    k2[:, :S - W], v2[:, :S - W] = 1e3, -1e3
    got = TL.blockwise_attention(q, k2, v2, chunk=16, window=W)
    assert torch.equal(got[:, -1], base[:, -1])
    assert not torch.equal(got[:, S - W], base[:, S - W])


# (S, q_offset, chunk, KVH): ragged S and ragged keys (padded to a chunk)
SKIP_CASES = [(40, 0, 16, 1), (64, 0, 16, 2), (33, 0, 8, 4), (100, 0, 64, 2),
              (24, 8, 8, 2), (37, 3, 16, 1)]


@pytest.mark.parametrize("S,q_offset,chunk,KVH", SKIP_CASES)
def test_causal_skip_attention(S, q_offset, chunk, KVH):
    """The online-softmax KV-chunk loop (chunk pairs above the diagonal
    skipped) against the reference's ``lax.cond`` scan, and against the
    masked mode where no skipped pair holds a live key (2e-4 / 2e-3)."""
    rng = np.random.RandomState(200 + S)
    B, H, D = 2, 8, 16
    q = randn(rng, B, S, H, D)
    k = randn(rng, B, S + q_offset, KVH, D)
    v = randn(rng, B, S + q_offset, KVH, D)
    want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), chunk=chunk,
                                  q_offset=q_offset, causal_skip=True)
    t = torch.from_numpy
    got = TL.blockwise_attention(t(q), t(k), t(v), chunk=chunk,
                                 q_offset=q_offset, causal_skip=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-3)
    if q_offset == 0:
        masked = TL.blockwise_attention(t(q), t(k), t(v), chunk=chunk)
        np.testing.assert_allclose(got.numpy(), masked.numpy(), atol=2e-4,
                                   rtol=2e-3)


def test_decode_attention_window():
    """Ring-buffer decode attention (liveness capped at the window)."""
    rng = np.random.RandomState(8)
    B, H, KVH, D, W = 3, 8, 2, 16, 12
    q = randn(rng, B, H, D)
    k, v = randn(rng, B, W, KVH, D), randn(rng, B, W, KVH, D)
    lens = np.array([3, 12, 40], np.int32)
    want = JL.decode_attention(*map(jnp.asarray, (q, k, v, lens)), window=W)
    got = TL.decode_attention(*map(torch.from_numpy, (q, k, v, lens)),
                              window=W)
    close(want, got)
