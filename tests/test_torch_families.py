"""The dense-shaped families' twins (starcoder2, minitron, qwen1.5,
musicgen, llava) against the JAX package's, on the CPU.

Each twin's ``forward`` against the reference's (2e-4 / 2e-3,
``tests/test_models.py``), on tokens or, for the ``frontend="embed"``
configs (musicgen, llava), on (B, S, E) embeddings; the embed configs
also prefill the paged cache from embeddings and decode a few steps
against the reference's serve path (logits 1e-4 / 1e-4, page tables and
small fields byte-equal, pools 1e-5, as ``tests/test_torch_serving.py``).
"""

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

DENSE_TWINS = ["starcoder2-15b", "minitron-8b", "qwen1.5-32b",
               "musicgen-large", "llava-next-34b"]
SMALL = ("next_free", "seq_ids", "seq_lens", "cur_page", "cur_off")


def model(name, seed=0):
    jcfg, cfg = jax_smoke_config(name), smoke_config(name)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    # the reference initialises biases to zero: give them values so the
    # qkv-bias path is compared
    if "bq" in jp["blocks"]:
        rng = np.random.RandomState(seed)
        jp["blocks"] = dict(jp["blocks"], **{
            k: jnp.asarray(rng.randn(*jp["blocks"][k].shape).astype(
                np.float32) * 0.1) for k in ("bq", "bk", "bv")})
    return jcfg, cfg, jp, convert.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, "cpu")


def inputs(cfg, B, S, seed):
    rng = np.random.RandomState(seed)
    if cfg.frontend == "embed":
        return rng.randn(B, S, cfg.d_model).astype(np.float32)
    return rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("S_len", [96, 37])
@pytest.mark.parametrize("name", DENSE_TWINS)
def test_twin_forward(name, S_len):
    jcfg, cfg, jp, p = model(name)
    x_in = inputs(cfg, 2, S_len, S_len)
    jx, _ = JT.forward(jcfg, jp, jnp.asarray(x_in))
    x, aux = T.forward(cfg, p, torch.from_numpy(x_in))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=2e-4,
                               rtol=2e-3)
    assert float(aux) == 0.0
    jl = JT.logits_fn(jcfg, jp, jx[:, -1])
    np.testing.assert_allclose(T.logits_fn(cfg, p, x[:, -1]).numpy(),
                               np.asarray(jl), atol=2e-4, rtol=2e-3)


def test_twin_norms_and_mlps():
    """The twins cover both norms and both MLPs, biases and no rope."""
    cfgs = {n: smoke_config(n) for n in DENSE_TWINS}
    assert {c.norm for c in cfgs.values()} == {"rms", "ln"}
    assert {c.mlp for c in cfgs.values()} == {"swiglu", "gelu"}
    assert cfgs["qwen1.5-32b"].qkv_bias and cfgs["starcoder2-15b"].qkv_bias
    assert not cfgs["musicgen-large"].rope


@pytest.mark.parametrize("name", ["musicgen-large", "llava-next-34b"])
def test_prefill_from_embeds_and_decode(name):
    jcfg, cfg, jp, p = model(name, seed=1)
    emb = inputs(cfg, 4, 32, 5)
    fed = np.random.RandomState(6).randint(0, cfg.vocab, (4, 5)).astype(
        np.int32)
    shape = dict(seq_len=96, global_batch=4, kind="decode")
    jgeom = JKC.make_geometry(jcfg, JShape("t", **shape), shards=2,
                              page_size=16)
    geom = KC.make_geometry(cfg, ShapeConfig("t", **shape), shards=2,
                            page_size=16, device="cpu")
    jl, jc = JE.prefill(jcfg, jgeom, jp, jnp.asarray(emb),
                        JKC.create_cache(jgeom))
    tl, tc = E.prefill(cfg, geom, p, torch.from_numpy(emb),
                       KC.create_cache(geom))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for i in range(fed.shape[1]):
        jl, jc = JE.serve_step(jcfg, jgeom, jp, jnp.asarray(fed[:, i]), jc)
        tl, tc = E.serve_step(cfg, geom, p, torch.from_numpy(fed[:, i]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    t = convert.cache_to_numpy(tc)
    for f in jc.table._fields:
        assert np.array_equal(np.asarray(getattr(jc.table, f)),
                              t["table"][f]), f
    for f in SMALL:
        assert np.array_equal(np.asarray(getattr(jc, f)), t[f]), f
    for f in ("kpool", "vpool"):
        np.testing.assert_allclose(t[f], np.asarray(getattr(jc, f)),
                                   atol=1e-5, rtol=0)


def test_unknown_parameter_leaf_is_named():
    cfg = smoke_config("yi-6b")
    with pytest.raises(ValueError, match="'w_bogus'"):
        convert.params_from_numpy({"embed": np.zeros((4, 4), np.float32),
                                   "blocks": {"w_bogus": np.zeros(2)}},
                                  cfg, "cpu")
