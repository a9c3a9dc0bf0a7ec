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


def test_unported_attention_modes_raise():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError):
        TL.blockwise_attention(x, x, x, chunk=4, window=2)
    with pytest.raises(NotImplementedError):
        TL.blockwise_attention(x, x, x, chunk=4, causal_skip=True)
