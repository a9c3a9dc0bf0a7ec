"""Decoder LM of the dense family: init, forward, and paged decode.

Port of ``repro.models.transformer`` (dense branch).  Parameters are plain
dicts; per-layer parameters are stacked along a leading L dim and the layer
stack is a Python loop over it (the reference's ``lax.scan``).  The
reference's ``shard(...)`` constraints are single-device no-ops and are
dropped.  Matrices that the reference casts to the model's dtype at every
use (``wq``, ``wk``, ``wv``, ``wo``, ``w_gate``, ``w_up``, ``w_down``, the
embedding) are stored in that dtype, which gives the values the reference
computes; norm scales and the LM head are read in float32 and stay so.

Decode runs against the hash-indexed paged KV pool (``serving/kvcache``):
every step translates (sequence, logical page) through the continuity page
table, writes the new token's k/v into its open page, and attends with the
paged-attention kernel directly on the pool through the page table, with
no gather.  The pools are updated in place.  Not ported yet: the moe, ssm
and hybrid families and their decode steps.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as K
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.serving import kvcache as KC

F32 = torch.float32
# stored in the model's dtype (the reference casts them at every use)
CAST_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up",
               "w_down")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_family(cfg: ModelConfig) -> None:
    """Raise unless the port runs ``cfg``'s family (dense so far)."""
    if cfg.moe is not None or cfg.ssm is not None or not cfg.has_attention:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            "(ROADMAP.md, Queue 1 #11)")


def embed_dtype(cfg: ModelConfig) -> torch.dtype:
    """Tied embeddings double as the float32 LM head, so they stay f32."""
    return F32 if cfg.tie_embeddings else _dtype(cfg)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``.  The
    distributions are the reference's (normal * 0.02, unit norm scales);
    the values differ from JAX's PRNG (``convert.params_from_numpy``
    carries the reference's across).  Each layer's slice is drawn in
    float32 and stored in its dtype, bounding the transient."""
    check_family(cfg)
    E, Lh, V = cfg.d_model, cfg.n_layers, cfg.padded_vocab
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev, dt = gen.device, _dtype(cfg)
    sc = 0.02

    def normal(shape, scale, dtype):
        if len(shape) < 3:                  # not stacked per layer
            return (torch.randn(shape, generator=gen, device=dev, dtype=F32)
                    * scale).to(dtype)
        out = torch.empty(shape, dtype=dtype, device=dev)
        for i in range(shape[0]):
            out[i] = torch.randn(shape[1:], generator=gen, device=dev,
                                 dtype=F32) * scale
        return out

    def const(shape, value, dtype=F32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    blocks = {"ln1_scale": const((Lh, E), 1.0), "ln2_scale": const((Lh, E), 1.0)}
    if cfg.norm == "ln":
        blocks["ln1_bias"] = const((Lh, E), 0.0)
        blocks["ln2_bias"] = const((Lh, E), 0.0)
    blocks["wq"] = normal((Lh, E, H * D), sc, dt)
    blocks["wk"] = normal((Lh, E, KVH * D), sc, dt)
    blocks["wv"] = normal((Lh, E, KVH * D), sc, dt)
    blocks["wo"] = normal((Lh, H * D, E), sc, dt)
    if cfg.qkv_bias:
        blocks["bq"] = const((Lh, H * D), 0.0, dt)
        blocks["bk"] = const((Lh, KVH * D), 0.0, dt)
        blocks["bv"] = const((Lh, KVH * D), 0.0, dt)
    if cfg.d_ff:
        if cfg.mlp == "swiglu":
            blocks["w_gate"] = normal((Lh, E, cfg.d_ff), sc, dt)
        blocks["w_up"] = normal((Lh, E, cfg.d_ff), sc, dt)
        blocks["w_down"] = normal((Lh, cfg.d_ff, E), sc, dt)
    params = {
        "embed": normal((V, E), sc if cfg.tie_embeddings else 1.0,
                        embed_dtype(cfg)),
        "blocks": blocks,
        "final_scale": const((E,), 1.0),
    }
    if cfg.norm == "ln":
        params["final_bias"] = const((E,), 0.0)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((E, V), sc, F32)
    return params


def layer_params(params: dict, layer: int) -> dict:
    """One layer's slice of the stacked block parameters (views)."""
    return {k: v[layer] for k, v in params["blocks"].items()}


# ---------------------------------------------------------------------------
# block forward (prefill / training forward)
# ---------------------------------------------------------------------------

def _attn_heads(cfg, p, x, positions, window):
    """Projection + rope + blockwise attention; returns concat head outputs
    (B, S, H*D) WITHOUT the output projection, plus (k, v) for cache fills."""
    B, Sq, E = x.shape
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, Sq, H, D)
    k = k.reshape(B, Sq, KVH, D)
    v = v.reshape(B, Sq, KVH, D)
    if cfg.rope:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    out = L.blockwise_attention(q, k, v, chunk=cfg.attn_chunk, window=window,
                                causal_skip=cfg.attn_mode == "causal_skip")
    return out.reshape(B, Sq, H * D), (k, v)


def _block_fwd(cfg: ModelConfig, x, p, window: int):
    """One dense decoder block with a static attention window (0 = full)."""
    check_family(cfg)
    Sq = x.shape[1]
    positions = torch.arange(Sq, device=x.device)[None]
    h = L.apply_norm(cfg, p, "ln1", x)
    attn, _ = _attn_heads(cfg, p, h, positions, window)
    x = x + attn @ p["wo"].to(x.dtype)
    x = x + L.mlp(cfg, p, L.apply_norm(cfg, p, "ln2", x))
    return x, torch.zeros((), dtype=F32, device=x.device)


def embed(cfg: ModelConfig, params: dict, inputs):
    """Token ids (..., ) -> embeddings, or precomputed embeds cast."""
    dt = _dtype(cfg)
    if inputs.dtype in (torch.int32, torch.int64):
        return params["embed"][inputs].to(dt)
    return inputs.to(dt)


def final_norm(cfg: ModelConfig, params: dict, x):
    if cfg.norm == "rms":
        return L.rmsnorm(x, params["final_scale"])
    return L.layernorm(x, params["final_scale"], params["final_bias"])


def forward(cfg: ModelConfig, params: dict, inputs):
    """Token (B, S) / embedding (B, S, E) inputs -> (hidden (B,S,E), aux)."""
    x = embed(cfg, params, inputs)
    aux = torch.zeros((), dtype=F32, device=x.device)
    for layer in range(cfg.n_layers):
        x, da = _block_fwd(cfg, x, layer_params(params, layer), cfg.window)
        aux = aux + da
    return final_norm(cfg, params, x), aux


def logits_fn(cfg: ModelConfig, params: dict, x) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x.to(F32) @ head.to(F32)
    if cfg.padded_vocab != cfg.vocab:    # mask padding ids everywhere
        live = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
        logits = torch.where(live, logits, -1e30)
    return logits


# ---------------------------------------------------------------------------
# decode (serving hot path)
# ---------------------------------------------------------------------------

def _rope_step(cfg, q, k, positions):
    if not cfg.rope:
        return q, k
    q = L.rope(q[:, None], positions[:, None], cfg.rope_theta)[:, 0]
    k = L.rope(k[:, None], positions[:, None], cfg.rope_theta)[:, 0]
    return q, k


def _qkv_step(cfg, p, h, positions):
    """h (B, E) -> q (B,H,D), k,v (B,KVH,D) with rope applied."""
    B = h.shape[0]
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = h @ p["wq"].to(h.dtype)
    k = h @ p["wk"].to(h.dtype)
    v = h @ p["wv"].to(h.dtype)
    if cfg.qkv_bias:
        q, k, v = (q + p["bq"].to(h.dtype), k + p["bk"].to(h.dtype),
                   v + p["bv"].to(h.dtype))
    q = q.reshape(B, H, D)
    k = k.reshape(B, KVH, D)
    v = v.reshape(B, KVH, D)
    return (*_rope_step(cfg, q, k, positions), v)


def _ffn_step(cfg, p, x):
    h2 = L.apply_norm(cfg, p, "ln2", x)
    return x + L.mlp(cfg, p, h2)


def _paged_layer_step(cfg, geom, p, x, kpool, vpool, page_table, cache):
    """One decoder layer of paged decode.  kpool/vpool: this layer's pool
    (DS, NPl, KVH, PS, D), written in place at each sequence's open page;
    page_table: (B, MAXP) ids into the pool viewed as (DS*NPl, ...)."""
    DS, Bl = geom.shards, geom.batch_per_shard
    B = DS * Bl
    positions = cache.seq_lens.reshape(B)
    h = L.apply_norm(cfg, p, "ln1", x)
    q, k, v = _qkv_step(cfg, p, h, positions)
    shard = torch.arange(DS, device=x.device).repeat_interleave(Bl)
    page, off = cache.cur_page.reshape(B).long(), cache.cur_off.reshape(B).long()
    kpool[shard, page, :, off] = k.to(kpool.dtype)
    vpool[shard, page, :, off] = v.to(vpool.dtype)
    pool_shape = (DS * geom.pool_pages,) + tuple(kpool.shape[2:])
    attn = K.paged_attention(q, kpool.view(pool_shape), vpool.view(pool_shape),
                             page_table, (cache.seq_lens + 1).reshape(B))
    x = x + attn.reshape(B, cfg.n_heads * cfg.hd) @ p["wo"].to(x.dtype)
    return _ffn_step(cfg, p, x)


def paged_layers(cfg: ModelConfig, params: dict, tokens, cache, geom,
                 page_table):
    """The decode step's layer stack: tokens (B,) -> hidden (B, E) before
    the final norm.  ``page_table``: ``lookup_pages``' (DS, Bl, MAXP)."""
    pt = KC.flat_page_table(geom, page_table)
    x = embed(cfg, params, tokens)
    for layer in range(cfg.n_layers):
        x = _paged_layer_step(cfg, geom, layer_params(params, layer), x,
                              cache.kpool[layer], cache.vpool[layer], pt,
                              cache)
    return x


def paged_decode_step(cfg: ModelConfig, params: dict, tokens, cache, geom):
    """tokens (B,) int -> (logits (B, V), cache).  The page table is
    re-translated through the continuity hash table every step (client
    reads); page opening/commit bookkeeping is in serving/engine.py."""
    check_family(cfg)
    page_table = KC.lookup_pages(geom, cache.table, cache.seq_ids)
    x = paged_layers(cfg, params, tokens, cache, geom, page_table)
    return logits_fn(cfg, params, final_norm(cfg, params, x)), cache
