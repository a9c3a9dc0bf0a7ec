"""Decoder LM of every family: init, forward, and decode.

Port of ``repro.models.transformer``.  Parameters are plain dicts;
per-layer parameters are stacked along a leading L dim and the layer
stack is a Python loop over it (the reference's ``lax.scan``).  Every
family shares this file: dense / moe / audio / vlm are one block shape;
hybrid (hymba) adds parallel SSM heads fused with the attention heads;
ssm (mamba2) drops attention.  Hybrid full-attention layers sit at
{0, L//2, L-1} (``layer_segments``); the others attend over a sliding
window.  Activations carry the reference's logical-axis constraints
(``distribution.sharding.shard``: the identity without a mesh, a DTensor
redistribution under ``use_mesh``); ``param_logical_axes`` names each
parameter's axes.  The paged decode's kernel reads the pools in place,
so the reference's constraint on the gathered pages has a counterpart
on the merged path only.  Matrices that the reference casts to the
model's dtype at every use (``CAST_LEAVES``) are stored in that dtype,
which gives the values the reference computes; norm scales, the router,
the SSM's decay and skip vectors and the LM head are read in float32
and stay so.  Training
keeps float32 masters of every leaf, as the reference does
(``init_params`` / ``convert.params_from_numpy`` with ``master_dtype``):
the forward casts each leaf where it is used, so gradients reach the
float32 leaves.  ``loss_fn`` is the causal-LM cross entropy with the
z-loss and the MoE's balance term; ``cfg.remat`` recomputes each layer
in the backward ("full") or all but its matrix products ("dots").

Full-attention families decode against the hash-indexed paged KV pool
(``serving/kvcache``): every step translates (sequence, logical page)
through the continuity page table, writes the new token's k/v into its
open page (int8 pools: quantized, with its scales), and attends with the
paged-attention kernel directly on the pool through the page table, with
no gather (``geom.merged_attn``: the reference's legacy path, pages
gathered and merged before a plain attention).  The pools are updated in
place.  Under a mesh each rank holds its shard of the cache (its data
shards' sequences, its slice of each page's tokens) and attends over it
with the kernel's page-token slice mode, the slices' partials merged
over the model axis ("split-KV" decode, the reference's GSPMD layout).  SSM and hybrid decode carry a state cache instead
(``kvcache.create_state_cache``: recurrent state, conv windows, hybrid's
ring buffers and global linear caches), also updated in place.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.distribution import sharding as SH
from repro_torch.distribution.sharding import shard
from repro_torch.kernels import ops as K
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.serving import kvcache as KC

F32 = torch.float32
# stored in the model's dtype (the reference casts them at every use)
CAST_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up",
               "w_down", "we_gate", "we_up", "we_down", "w_fuse",
               "ssm_in_proj", "ssm_out_proj", "ssm_conv_w")
# read in float32 wherever they are used
F32_LEAVES = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
              "final_scale", "final_bias", "lm_head", "router",
              "ssm_A_log", "ssm_D", "ssm_dt_bias", "ssm_ssm_norm",
              "ssm_conv_b", "fuse_attn_scale", "fuse_ssm_scale")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def leaf_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """The port's storage dtype of parameter leaf ``name``."""
    if name in F32_LEAVES:
        return F32
    if name == "embed":
        return embed_dtype(cfg)
    if name in CAST_LEAVES:
        return _dtype(cfg)
    raise ValueError(f"{cfg.name}: unknown parameter leaf {name!r}")


def embed_dtype(cfg: ModelConfig) -> torch.dtype:
    """Tied embeddings double as the float32 LM head, so they stay f32."""
    return F32 if cfg.tie_embeddings else _dtype(cfg)


def _require_paged(cfg: ModelConfig) -> None:
    """The paged KV pool serves the full-attention families only."""
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family decodes through the state "
            "cache (kvcache.create_state_cache, engine.serve_step with no "
            "geometry), not the paged KV pool")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator,
                master_dtype=None) -> dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``.  The
    distributions are the reference's (normal * 0.02, unit norm scales,
    Mamba-2's decay and dt inits); the values differ from JAX's PRNG
    (``convert.params_from_numpy`` carries the reference's across).  Each
    layer's slice is drawn in float32 and stored in its dtype
    (``leaf_dtype``; every leaf in ``master_dtype`` when it is given, the
    training masters), bounding the transient."""
    E, Lh, V = cfg.d_model, cfg.n_layers, cfg.padded_vocab
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = gen.device
    sc = 0.02

    def dtype_of(name):
        return master_dtype or leaf_dtype(cfg, name)

    def normal(name, shape, scale=sc):
        dtype = dtype_of(name)
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
    if cfg.has_attention:
        blocks["wq"] = normal("wq", (Lh, E, H * D))
        blocks["wk"] = normal("wk", (Lh, E, KVH * D))
        blocks["wv"] = normal("wv", (Lh, E, KVH * D))
        if cfg.family != "hybrid":
            blocks["wo"] = normal("wo", (Lh, H * D, E))
        if cfg.qkv_bias:
            for name, n in (("bq", H * D), ("bk", KVH * D), ("bv", KVH * D)):
                blocks[name] = const((Lh, n), 0.0, dtype_of(name))
    if cfg.moe is not None:
        m = cfg.moe
        blocks["router"] = normal("router", (Lh, E, m.num_experts))
        blocks["we_gate"] = normal("we_gate", (Lh, m.num_experts, E,
                                               m.expert_dff))
        blocks["we_up"] = normal("we_up", (Lh, m.num_experts, E,
                                           m.expert_dff))
        blocks["we_down"] = normal("we_down", (Lh, m.num_experts,
                                               m.expert_dff, E))
    elif cfg.d_ff:
        if cfg.mlp == "swiglu":
            blocks["w_gate"] = normal("w_gate", (Lh, E, cfg.d_ff))
        blocks["w_up"] = normal("w_up", (Lh, E, cfg.d_ff))
        blocks["w_down"] = normal("w_down", (Lh, cfg.d_ff, E))
    if cfg.ssm is not None:
        layers = [S.init_ssm_params(gen, cfg) for _ in range(Lh)]
        for k in layers[0]:
            if k == "out_proj" and cfg.family == "hybrid":
                continue               # the fused projection replaces it
            blocks[f"ssm_{k}"] = torch.stack([lp[k] for lp in layers]).to(
                dtype_of(f"ssm_{k}"))
        del layers
        if cfg.family == "hybrid":
            d_inner = S.ssm_dims(cfg)[0]
            assert d_inner == H * D, (d_inner, H * D)
            blocks["fuse_attn_scale"] = const((Lh, H * D), 1.0)
            blocks["fuse_ssm_scale"] = const((Lh, d_inner), 1.0)
            blocks["w_fuse"] = normal("w_fuse", (Lh, H * D, E))
    # tied embeddings double as the LM head: init small to keep initial
    # logits O(1) (the first block norm makes the input side scale-free)
    params = {
        "embed": normal("embed", (V, E), sc if cfg.tie_embeddings else 1.0),
        "blocks": blocks,
        "final_scale": const((E,), 1.0),
    }
    if cfg.norm == "ln":
        params["final_bias"] = const((E,), 0.0)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal("lm_head", (E, V))
    return params


def param_logical_axes(cfg: ModelConfig, params: dict) -> dict:
    """Mirror of ``params`` with logical-axis tuples per leaf."""
    ax = {
        "embed": ("vocab", "embed"),
        "final_scale": ("embed",),
        "final_bias": ("embed",),
        "lm_head": ("embed", "vocab"),
    }
    bl = {
        "ln1_scale": ("layers", "embed"), "ln1_bias": ("layers", "embed"),
        "ln2_scale": ("layers", "embed"), "ln2_bias": ("layers", "embed"),
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
        "bq": ("layers", "heads"), "bk": ("layers", "kv_heads"),
        "bv": ("layers", "kv_heads"),
        "router": ("layers", "embed", None),
        "we_gate": ("layers", "experts", "embed", "expert_mlp"),
        "we_up": ("layers", "experts", "embed", "expert_mlp"),
        "we_down": ("layers", "experts", "expert_mlp", "embed"),
        "w_gate": ("layers", "embed", "mlp"),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
        "ssm_in_proj": ("layers", "embed", "ssm_inner"),
        "ssm_conv_w": ("layers", None, None),
        "ssm_conv_b": ("layers", None),
        "ssm_A_log": ("layers", None), "ssm_D": ("layers", None),
        "ssm_dt_bias": ("layers", None),
        "ssm_ssm_norm": ("layers", "ssm_inner"),
        "ssm_out_proj": ("layers", "ssm_inner", "embed"),
        "fuse_attn_scale": ("layers", "heads"),
        "fuse_ssm_scale": ("layers", "ssm_inner"),
        "w_fuse": ("layers", "heads", "embed"),
    }
    out = {k: ax[k] for k in params if k != "blocks"}
    out["blocks"] = {k: bl[k] for k in params["blocks"]}
    return out


def layer_params(params: dict, layer: int) -> dict:
    """One layer's slice of the stacked block parameters (views)."""
    return {k: v[layer] for k, v in params["blocks"].items()}


def _ssm_leaves(p: dict) -> dict:
    """A layer's SSM parameters without their ``ssm_`` prefix."""
    return {k[4:]: v for k, v in p.items() if k.startswith("ssm_")}


# ---------------------------------------------------------------------------
# layer segmentation (static per-layer attention windows for hybrids)
# ---------------------------------------------------------------------------

def layer_segments(cfg: ModelConfig) -> List[Tuple[int, int, int]]:
    """[(start, stop, window)] covering 0..L; window=0 means full attention.

    Hybrids (hymba) use full attention at layers {0, L//2, L-1} and a
    sliding window elsewhere; all other families are one segment.
    """
    Lh = cfg.n_layers
    if cfg.family != "hybrid":
        return [(0, Lh, cfg.window)]
    glob = sorted({0, Lh // 2, Lh - 1})
    segs, prev = [], 0
    for g in glob:
        if g > prev:
            segs.append((prev, g, cfg.window))
        segs.append((g, g + 1, 0))
        prev = g + 1
    if prev < Lh:
        segs.append((prev, Lh, cfg.window))
    return segs


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Each layer's static attention window (0 = full), in layer order."""
    return [w for a, b, w in layer_segments(cfg) for _ in range(a, b)]


# ---------------------------------------------------------------------------
# block forward (prefill / training forward)
# ---------------------------------------------------------------------------

def _split_heads(x, n: int, D: int, name: str):
    """(B, ..., n * D) -> (B, ..., n, D).  Under a mesh the last dim is
    first placed as the heads will be: DTensor cannot split a dim sharded
    into chunks that do not hold whole heads (the head count not divisible
    by the model axis, as GQA's kv heads), so it is replicated there."""
    lead = tuple(x.shape[:-1])
    if SH.is_dtensor(x):
        mid = (None,) * (len(lead) - 1)
        spec = SH.logical_spec("batch", *mid, name, None,
                               size_of=lead + (n, D))
        x = shard(x, "batch", *mid, name if spec[-2] else None)
    return x.reshape(*lead, n, D)


def _merge_heads(x):
    """(B, S, n, D) -> (B, S, n * D); under a mesh the merged dim keeps the
    heads' placement, so the backward hands the view a gradient it can
    split (see ``_split_heads``)."""
    B, Sq, n, D = x.shape
    out = x.reshape(B, Sq, n * D)
    if SH.is_dtensor(out):
        spec = SH.logical_spec("batch", None, "heads", None, size_of=x.shape)
        out = shard(out, "batch", None, "heads" if spec[2] else None)
    return out


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
    q = _split_heads(q, H, D, "heads")
    k = _split_heads(k, KVH, D, "kv_heads")
    v = _split_heads(v, KVH, D, "kv_heads")
    if cfg.constrain_qkv:
        # seq is NOT bound here: under sequence parallelism the residual
        # stream is seq-sharded but attention runs on the gathered sequence
        q = shard(q, "batch", None, "heads", None)
        k = shard(k, "batch", None, "kv_heads", None)
        v = shard(v, "batch", None, "kv_heads", None)
    if cfg.rope:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    out = L.blockwise_attention(q, k, v, chunk=cfg.attn_chunk, window=window,
                                causal_skip=cfg.attn_mode == "causal_skip")
    return _merge_heads(out), (k, v)


def _ssm_part(cfg, p, h, apply_out: bool):
    return S.ssd_forward(cfg, _ssm_leaves(p), h, apply_out=apply_out)


def _fuse(cfg, p, attn, y_ssm, dt):
    """Hybrid heads: each side RMS-normed, averaged, one projection."""
    a = L.rmsnorm(attn, p["fuse_attn_scale"])
    s_ = L.rmsnorm(y_ssm, p["fuse_ssm_scale"])
    return ((a + s_) * 0.5).to(dt) @ p["w_fuse"].to(dt)


def ffn(cfg, p, h2):
    """The block's feed-forward on normed h2 (B, S, E): the MoE layer or
    the MLP; returns (out, moe aux)."""
    if cfg.moe is not None:
        return L.moe(cfg, p, h2)
    return L.mlp(cfg, p, h2), torch.zeros((), dtype=F32, device=h2.device)


def _block_fwd(cfg: ModelConfig, x, p, window: int):
    """One decoder block with a static attention window (0 = full)."""
    Sq = x.shape[1]
    positions = torch.arange(Sq, device=x.device)[None]
    aux = torch.zeros((), dtype=F32, device=x.device)

    if cfg.family == "hybrid":
        h = L.apply_norm(cfg, p, "ln1", x)
        attn, _ = _attn_heads(cfg, p, h, positions, window)
        # the SSM heads' output keeps its own placement (ssm_inner): the
        # backward then brings the fused gradient back to it before the
        # SSM splits its heads (see ``_split_heads``)
        y_ssm = shard(_ssm_part(cfg, p, h, apply_out=False),
                      "batch", "seq", "ssm_inner")
        x = x + shard(_fuse(cfg, p, attn, y_ssm, x.dtype),
                      "batch", "seq", "embed")
        x = x + L.mlp(cfg, p, L.apply_norm(cfg, p, "ln2", x))
        return x, aux

    if cfg.family == "ssm":
        h = L.apply_norm(cfg, p, "ln1", x)
        x = x + _ssm_part(cfg, p, h, apply_out=True)
        if cfg.d_ff:
            x = x + L.mlp(cfg, p, L.apply_norm(cfg, p, "ln2", x))
        return x, aux

    # dense / moe / audio / vlm
    h = L.apply_norm(cfg, p, "ln1", x)
    attn, _ = _attn_heads(cfg, p, h, positions, window)
    x = x + shard(attn @ p["wo"].to(x.dtype), "batch", "seq", "embed")
    out, aux = ffn(cfg, p, L.apply_norm(cfg, p, "ln2", x))
    return x + out, aux


def embed(cfg: ModelConfig, params: dict, inputs):
    """Token ids (..., ) -> embeddings, or precomputed embeds cast."""
    dt = _dtype(cfg)
    if inputs.dtype in (torch.int32, torch.int64):
        if SH.is_dtensor(inputs):
            return _embed_local(params["embed"], inputs).to(dt)
        return params["embed"][inputs].to(dt)
    return inputs.to(dt)


def _embed_local(table, ids):
    """The embedding gather under a mesh: the (vocab-sharded) table is
    replicated and every rank gathers the rows of its own ids; the local
    table's gradient is partial over the mesh dims that shard the ids.
    (DTensor's rule for the gather's backward, an accumulating
    ``index_put``, fails in some torch releases.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = ids.device_mesh
    grad = [Partial() if isinstance(p, Shard) else Replicate()
            for p in ids.placements]
    local = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grad)
    out = local[ids.to_local()]
    shape = tuple(ids.shape) + (table.shape[1],)
    return DTensor.from_local(out, mesh, ids.placements, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def final_norm(cfg: ModelConfig, params: dict, x):
    if cfg.norm == "rms":
        return L.rmsnorm(x, params["final_scale"])
    return L.layernorm(x, params["final_scale"], params["final_bias"])


# matrix products without batch dimensions: what "dots" keeps (the
# counterpart of dots_with_no_batch_dims_saveable); attention's batched
# products are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable():
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in _DOTS
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _remat(cfg: ModelConfig, fn):
    """``fn`` (one layer) under ``cfg.remat``, as the reference's
    ``jax.checkpoint`` policies: "none" keeps every activation for the
    backward, "full" keeps the layer's input alone and recomputes the
    layer (``nothing_saveable``), "dots" keeps the outputs of its matrix
    products and recomputes the rest.  Without autograd (serving, checks)
    the layer runs as it is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import checkpoint
    if cfg.remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if cfg.remat == "dots":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=_dots_saveable)
    raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r}")


def forward(cfg: ModelConfig, params: dict, inputs):
    """Token (B, S) / embedding (B, S, E) inputs -> (hidden (B,S,E), moe
    aux scalar).  Each layer runs with its segment's static window, under
    ``cfg.remat``."""
    x = shard(embed(cfg, params, inputs), "batch", "seq", "embed")
    aux = torch.zeros((), dtype=F32, device=x.device)
    for layer, window in enumerate(layer_windows(cfg)):
        def block(x, p, _w=window):
            return _block_fwd(cfg, x, p, _w)
        x, da = _remat(cfg, block)(x, layer_params(params, layer))
        aux = aux + da
    return final_norm(cfg, params, x), aux


def logits_fn(cfg: ModelConfig, params: dict, x) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x.to(F32) @ head.to(F32)
    if cfg.padded_vocab != cfg.vocab:    # mask padding ids everywhere
        live = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
        logits = torch.where(live, logits, -1e30)
    if logits.dim() == 3:
        return shard(logits, "batch", None, "vocab")
    return shard(logits, "batch", "vocab")


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Causal-LM cross entropy (labels pre-shifted by the data pipeline)
    over the masked padded vocabulary, plus the z-loss 1e-4 * mean(logz^2)
    and, for MoE, 1e-2 * the balance term."""
    x, aux = forward(cfg, params, batch["inputs"])
    logits = logits_fn(cfg, params, x)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    # DTensor's gather along a vocab-sharded dim mis-reduces its masked
    # partial: the gold logits are read from the vocab gathered per rank
    gold = torch.gather(shard(logits, "batch", None, None), -1,
                        labels[..., None])[..., 0]
    ce = torch.mean(logz - gold)
    zloss = 1e-4 * torch.mean(torch.square(logz))
    moe_w = 1e-2 if cfg.moe is not None else 0.0
    return ce + zloss + moe_w * aux


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
    q, k, v = _qkv_proj(cfg, p, h)
    return (*_rope_step(cfg, q, k, positions), v)


def _qkv_proj(cfg, p, h):
    """h (B, E) -> q (B,H,D), k,v (B,KVH,D) before rope."""
    B = h.shape[0]
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = h @ p["wq"].to(h.dtype)
    k = h @ p["wk"].to(h.dtype)
    v = h @ p["wv"].to(h.dtype)
    if cfg.qkv_bias:
        q, k, v = (q + p["bq"].to(h.dtype), k + p["bk"].to(h.dtype),
                   v + p["bv"].to(h.dtype))
    q = _split_heads(q, H, D, "heads")
    k = _split_heads(k, KVH, D, "kv_heads")
    v = _split_heads(v, KVH, D, "kv_heads")
    return q, k, v


def _ffn_step(cfg, p, x):
    h2 = L.apply_norm(cfg, p, "ln2", x)
    return x + ffn(cfg, p, h2[:, None])[0][:, 0]


def _gathered_pages(kpool, vpool, kscale, vscale, page_table, dtype):
    """Every page of the table gathered (an unmapped one as page 0, masked
    later by the length), dequantized to ``dtype`` when int8: (B, MAXP,
    KVH, PS, D) each."""
    pt = page_table.clamp(min=0).long()
    kg, vg = kpool[pt], vpool[pt]
    if kscale is not None:
        kg = KC.dequant(kg, kscale[pt], dtype)
        vg = KC.dequant(vg, vscale[pt], dtype)
    return kg, vg


def _merged_attention(geom, q, kpool, vpool, kscale, vscale, page_table,
                      lens, dtype):
    """The reference's legacy decode path (``geom.merged_attn``): the
    gathered pages (MAXP, PS) merged into one token range, and plain decode
    attention over it.  No kernel."""
    B = q.shape[0]
    kg, vg = _gathered_pages(kpool, vpool, kscale, vscale, page_table, dtype)
    T_ = geom.max_pages * geom.page_size

    def merged(g):
        """(B, MAXP, KVH, PS, D) -> (B, T, KVH, D), constrained as the
        reference's (DS, Bl, MAXP, PS, KVH, D) view."""
        g = g.reshape(geom.shards, geom.batch_per_shard, *g.shape[1:])
        g = shard(g.movedim(4, 3), "kv_shard", None, None, "page_tokens",
                  None, None)
        return g.reshape(B, T_, geom.kv_heads, geom.head_dim)
    kf, vf = merged(kg), merged(vg)
    return L.decode_attention(q, kf, vf, lens)


def _store_token(geom, cache, k, v, kpool, vpool, kscale, vscale):
    """The new token's k/v (B, KVH, D) written in place at each sequence's
    open page of this layer's pools (DS, NPl, KVH, PS, D) (int8 pools: its
    ``quant_store`` values, its scales into kscale/vscale); over page-token
    slices only the rank whose slice holds ``cur_off`` writes.  Returns the
    pools and scales viewed as (DS*NPl, ...), the kernel's layout."""
    DS, Bl = geom.shards, geom.batch_per_shard
    B = DS * Bl
    rows = torch.arange(DS, device=k.device).repeat_interleave(Bl)
    page = cache.cur_page.reshape(B).long()
    slot = cache.cur_off.reshape(B).long() - geom.token_offset
    mine = None
    if geom.page_slices > 1:
        mine = (slot >= 0) & (slot < geom.slice_tokens)
        slot = slot.clamp(0, geom.slice_tokens - 1)
    if kscale is not None:
        k, ks = KC.quant_store(k)
        v, vs = KC.quant_store(v)
        _write_slot(kscale, rows, page, slot, mine, ks)
        _write_slot(vscale, rows, page, slot, mine, vs)
    _write_slot(kpool, rows, page, slot, mine, k)
    _write_slot(vpool, rows, page, slot, mine, v)

    def flat(pool):
        if pool is None:
            return None
        return pool.view((DS * geom.pool_pages,) + tuple(pool.shape[2:]))
    return flat(kpool), flat(vpool), flat(kscale), flat(vscale)


def _write_slot(pool, rows, page, slot, mine, val) -> None:
    """``pool[rows, page, :, slot] = val`` in place; where ``mine`` is given,
    only its rows are written (the others write back what they read)."""
    val = val.to(pool.dtype)
    if mine is not None:
        val = torch.where(mine[:, None, None], val, pool[rows, page, :, slot])
    pool[rows, page, :, slot] = val


def _paged_layer_step(cfg, geom, p, x, kpool, vpool, page_table, cache,
                      kscale=None, vscale=None):
    """One decoder layer of paged decode.  kpool/vpool: this layer's pool
    (DS, NPl, KVH, PS, D), written in place at each sequence's open page
    (int8 pools: the token's ``quant_store`` values, its scales into
    kscale/vscale (DS, NPl, KVH, PS, 1)); page_table: (B, MAXP) ids into
    the pool viewed as (DS*NPl, ...)."""
    B = geom.shards * geom.batch_per_shard
    positions = cache.seq_lens.reshape(B)
    h = L.apply_norm(cfg, p, "ln1", x)
    q, k, v = _qkv_step(cfg, p, h, positions)
    fk, fv, fks, fvs = _store_token(geom, cache, k, v, kpool, vpool, kscale,
                                    vscale)
    lens = positions + 1
    if geom.merged_attn:
        attn = _merged_attention(geom, q, fk, fv, fks, fvs, page_table, lens,
                                 x.dtype)
    else:
        attn = K.paged_attention(q, fk, fv, page_table, lens, kscale=fks,
                                 vscale=fvs)
    x = x + attn.reshape(B, cfg.n_heads * cfg.hd) @ p["wo"].to(x.dtype)
    return _ffn_step(cfg, p, x)


def _batch_local(t):
    """A DTensor's rows of this rank's sequences with every other dim whole
    (gathered over the model axis), as a plain contiguous tensor."""
    spec = SH.logical_spec("batch", *(None,) * (t.dim() - 1),
                           size_of=tuple(t.shape))
    mesh = t.device_mesh
    return SH.to_placements(t, mesh, SH.placements(spec, mesh)).to_local() \
        .contiguous()


def _head_group(mesh, H: int, D: int):
    """(first head, heads, first column, columns) of this rank's share of
    the attention output (B, H * D): its row shard of ``wo``.  Where the
    heads divide over the model axis it is a group of whole heads; where
    only H * D does (40 heads on 16 ranks), the rank needs every head and
    keeps its columns."""
    first, count = SH.chunk_of(SH.logical_spec("heads",
                                               size_of=(H * D,))[0], mesh)
    cols = H * D // count
    if H % count:
        return 0, H, first * cols, cols
    return first * (H // count), H // count, 0, cols


def _all_gather(x, dim: int, group):
    """The model group's ``x`` concatenated along ``dim`` in rank order (a
    functional collective, which ``CommDebugMode`` counts); waited on."""
    import torch.distributed._functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor      # the name in older torch releases
    return funcol.wait_tensor(gather(x.contiguous(), dim, group))


def _merge_slices(geom, mesh, acc, ml, dtype, first: int, nh: int):
    """This rank's heads ``[first, first + nh)`` of the attention output
    from the page-token slices' partials (acc (B, H, S, D), ml (B, H, S,
    2): its own slice's splits).  Over m > 1 slices the model group
    exchanges them, one ``all_to_all_single`` by head group where the
    heads divide over the model axis (else an ``all_gather`` of every
    head), and the merge kernel sums every slice's splits in rank order."""
    import torch.distributed._functional_collectives as funcol
    m = geom.page_slices
    B, H, S, D = acc.shape
    if m == 1:
        return K.merge_partials(acc[:, first:first + nh],
                                ml[:, first:first + nh], dtype)
    group = mesh.get_group("model")
    buf = torch.cat([acc, ml], -1)                   # (B, H, S, D + 2)
    if nh * m == H:
        send = buf.reshape(B, m, nh, S, D + 2).movedim(1, 0).contiguous()
        recv = funcol.wait_tensor(
            funcol.all_to_all_single(send, None, None, group))
    else:
        recv = _all_gather(buf[None], 0, group)
    parts = recv.movedim(0, 2).reshape(B, nh, m * S, D + 2)
    return K.merge_partials(parts[..., :D].contiguous(),
                            parts[..., D:].contiguous(), dtype)


def _merged_slices(geom, mesh, q, kpool, vpool, kscale, vscale, page_table,
                   lens, dtype):
    """The merged path under a mesh: this rank's token slice of every page
    of the table gathered, the model group's slices all-gathered into
    whole pages (the reference's constraint keeps the gathered pages
    split over the model axis, and merging (MAXP, PS) into one token range
    gathers them), then plain decode attention over the merged range."""
    kg, vg = _gathered_pages(kpool, vpool, kscale, vscale, page_table, dtype)
    if geom.page_slices > 1:
        group = mesh.get_group("model")
        kg, vg = (_all_gather(g, 3, group) for g in (kg, vg))
    B = q.shape[0]
    T_ = geom.max_pages * geom.page_size
    kf, vf = (g.movedim(3, 2).reshape(B, T_, geom.kv_heads, geom.head_dim)
              for g in (kg, vg))
    return L.decode_attention(q, kf, vf, lens)


def _sharded_layer_step(cfg, geom, p, x, kpool, vpool, page_table, cache,
                        kscale=None, vscale=None):
    """``_paged_layer_step`` under a mesh: ``x`` a DTensor (B, E) of the
    global batch; the pools, page table and cache fields this rank's shard
    (``kvcache.shard_cache``: its sequences, its token slice of each
    page).  The projections run on the DTensors (q over the heads' shard);
    q, k and v are gathered to this rank's sequences with every head.  The
    rank whose slice holds ``cur_off`` writes the new token (int8: its
    ``quant_store`` values and scales), and every rank attends over its
    slice with the kernel's slice mode for all H heads, the partials
    merged over the model group (``_merge_slices``); the output projection
    takes the rank's head group as a DTensor again."""
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    B, H, D = geom.shards * geom.batch_per_shard, cfg.n_heads, cfg.hd
    positions = cache.seq_lens.reshape(B)
    h = L.apply_norm(cfg, p, "ln1", x)
    q, k, v = (_batch_local(t) for t in _qkv_proj(cfg, p, h))
    q, k = _rope_step(cfg, q, k, positions)
    fk, fv, fks, fvs = _store_token(geom, cache, k, v, kpool, vpool, kscale,
                                    vscale)
    lens = positions + 1
    first, nh, col, cols = _head_group(mesh, H, D)
    if geom.merged_attn:
        out = _merged_slices(geom, mesh, q, fk, fv, fks, fvs, page_table,
                             lens, x.dtype)[:, first:first + nh]
    else:
        acc, ml = K.paged_attention(q, fk, fv, page_table, lens, kscale=fks,
                                    vscale=fvs, page_stride=geom.page_size,
                                    token_offset=geom.token_offset)
        out = _merge_slices(geom, mesh, acc, ml, x.dtype, first, nh)
    shape = torch.Size((x.shape[0], H * D))
    pl = SH.placements(SH.logical_spec("batch", "heads", size_of=shape), mesh)
    attn = DTensor.from_local(out.reshape(B, nh * D)[:, col:col + cols],
                              mesh, pl, run_check=False, shape=shape,
                              stride=(H * D, 1))
    x = x + attn @ p["wo"].to(x.dtype)
    return _ffn_step(cfg, p, x)


def paged_layers(cfg: ModelConfig, params: dict, tokens, cache, geom,
                 page_table):
    """The decode step's layer stack: tokens (B,) -> hidden (B, E) before
    the final norm.  ``page_table``: ``lookup_pages``' (DS, Bl, MAXP).
    Under a mesh ``tokens`` are the global batch's, the cache and page
    table this rank's shard, and the hidden state a DTensor."""
    pt = KC.flat_page_table(geom, page_table)
    sharded = SH.get_mesh() is not None
    if sharded:
        tokens = shard(tokens, "batch")
    x = shard(embed(cfg, params, tokens), "batch", "embed")
    step = _sharded_layer_step if sharded else _paged_layer_step
    quant = cache.kscale is not None
    for layer in range(cfg.n_layers):
        x = step(
            cfg, geom, layer_params(params, layer), x, cache.kpool[layer],
            cache.vpool[layer], pt, cache,
            cache.kscale[layer] if quant else None,
            cache.vscale[layer] if quant else None)
    return x


def paged_decode_step(cfg: ModelConfig, params: dict, tokens, cache, geom):
    """tokens (B,) int -> (logits (B, V), cache).  The page table is
    re-translated through the continuity hash table every step (client
    reads); page opening/commit bookkeeping is in serving/engine.py.
    Under a mesh the cache is this rank's shard (``kvcache.shard_cache``)
    and the logits the full tensor on every rank."""
    _require_paged(cfg)
    page_table = KC.lookup_pages(geom, cache.table, cache.seq_ids)
    with SH.mesh_context():
        x = paged_layers(cfg, params, tokens, cache, geom, page_table)
        logits = logits_fn(cfg, params, final_norm(cfg, params, x))
        return SH.gather(logits), cache


def ssm_decode_step(cfg: ModelConfig, params: dict, tokens, cache):
    """SSM decode: O(1) recurrent state per layer.  cache: {"S", "conv",
    "seq_lens"} with leading layer dims on S/conv, updated in place;
    returns (logits (B, V), the cache with ``seq_lens`` + 1)."""
    x = shard(embed(cfg, params, tokens), "batch", "embed")
    for layer in range(cfg.n_layers):
        p = layer_params(params, layer)
        h = L.apply_norm(cfg, p, "ln1", x)
        st = {"S": cache["S"][layer], "conv": cache["conv"][layer]}
        y, st = S.ssd_decode(cfg, _ssm_leaves(p), h, st, apply_out=True)
        cache["S"][layer] = st["S"]
        cache["conv"][layer] = st["conv"]
        x = x + y
        if cfg.d_ff:
            x = _ffn_step(cfg, p, x)
    x = L.rmsnorm(x, params["final_scale"])
    return logits_fn(cfg, params, x), dict(cache,
                                           seq_lens=cache["seq_lens"] + 1)


def _write_token(buf, rows, pos, val) -> None:
    """``buf[rows, pos] = val`` in place (buf: (B, T, KVH, D)).  Under a
    mesh the token dim is sharded and DTensor has no in-place rule for
    that scatter: the buffer is rebuilt out of place under a one-hot mask
    of the positions and copied back."""
    if SH.is_dtensor(buf):
        hit = torch.arange(buf.shape[1], device=pos.device)[None] \
            == pos[:, None]
        buf.copy_(torch.where(hit[:, :, None, None],
                              val[:, None].to(buf.dtype), buf))
        return
    buf[rows, pos] = val.to(buf.dtype)


def ring_slot(seq_lens, window: int):
    """A windowed layer's ring-buffer slot for the token at ``seq_lens``."""
    return seq_lens % window


def hybrid_decode_step(cfg: ModelConfig, params: dict, tokens, cache):
    """Hybrid decode: ring-buffer window attention + linear caches for the
    global layers + SSM state, all in parallel heads; layers in order with
    their static windows.  The cache is updated in place; returns (logits
    (B, V), the cache with ``seq_lens`` + 1).  Rope is applied at the
    absolute position before a k is cached."""
    x = shard(embed(cfg, params, tokens), "batch", "embed")
    seq_lens = cache["seq_lens"]                            # (B,)
    B = x.shape[0]
    W = cfg.window
    rows = torch.arange(B, device=x.device)
    wi = gi = 0
    for layer, window in enumerate(layer_windows(cfg)):
        p = layer_params(params, layer)
        h = L.apply_norm(cfg, p, "ln1", x)
        q, k, v = _qkv_step(cfg, p, h, seq_lens)
        if window:                                          # ring buffer
            kc, vc = cache["ring_k"][wi], cache["ring_v"][wi]
            slot = ring_slot(seq_lens, W).long()
            _write_token(kc, rows, slot, k)
            _write_token(vc, rows, slot, v)
            attn = L.decode_attention(q, kc, vc, seq_lens + 1, window=W)
            wi += 1
        else:                                               # global linear
            kc, vc = cache["glob_k"][gi], cache["glob_v"][gi]
            _write_token(kc, rows, seq_lens.long(), k)
            _write_token(vc, rows, seq_lens.long(), v)
            attn = L.decode_attention(q, kc, vc, seq_lens + 1)
            gi += 1
        st = {"S": cache["S"][layer], "conv": cache["conv"][layer]}
        y_ssm, st = S.ssd_decode(cfg, _ssm_leaves(p), h, st, apply_out=False)
        cache["S"][layer] = st["S"]
        cache["conv"][layer] = st["conv"]
        x = x + _fuse(cfg, p, attn.reshape(B, -1), y_ssm, x.dtype)
        x = _ffn_step(cfg, p, x)
    x = L.rmsnorm(x, params["final_scale"])
    return logits_fn(cfg, params, x), dict(cache, seq_lens=seq_lens + 1)
