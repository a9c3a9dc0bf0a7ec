"""Batched decode engine: the paper's read/write protocol on the serving path.

Port of ``repro.serving.engine``.  ``serve_step`` of the full-attention
families (dense, moe, audio, vlm):
  1. advance(): sequences crossing a page boundary get a physical page
     allocated and the (seq, page)->phys mapping INSERTED into the continuity
     hash table (server-side write: payload, then one atomic indicator
     commit);
  2. lookup_pages(): every (seq, logical page) is translated through the hash
     table (client read: ONE contiguous segment fetch each, the segment-probe
     kernel on a card);
  3. the model decodes one token, attending over the pool through the page
     table with the paged-attention kernel;
  4. commit_token().

The ssm and hybrid families step their state cache instead
(``kvcache.create_state_cache``); prefill is theirs token by token
through ``serve_step``.

With ``kv_dtype="int8"`` prefill stores each prompt token's k/v as
``quant_store`` values and scales, as decode does.  This is a deliberate
divergence: the reference's prefill casts the float k/v straight into the
int8 pools and writes no scale, so every prompt token dequantizes to 0
(ROADMAP Queue 3).

``release_sequence`` returns a finished sequence's pages (hash-table
deletes: one indicator-bit clear each, the paper's 1-PM-write deletion,
matched by the mutation-plan kernel on a card).  ``content_page_keys``
builds content-addressed page keys for prefix sharing.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.hashfn import fold_u32, mix_pair
from repro_torch.core.words import to_i32
from repro_torch.distribution import sharding as SH
from repro_torch.distribution.sharding import shard
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving import kvcache as KC

I32 = torch.int32
CONTENT_SALT = 0x9E3779B9


def serve_step(cfg: ModelConfig, geom: Optional[KC.PageGeometry],
               params: dict, tokens: torch.Tensor, cache):
    """One decode step for any family.  tokens (B,) int -> (logits (B, V),
    cache): the ssm and hybrid families step their state cache
    (``geom`` unused, None), the others the paged cache."""
    if cfg.family == "ssm":
        return T.ssm_decode_step(cfg, params, tokens, cache)
    if cfg.family == "hybrid":
        return T.hybrid_decode_step(cfg, params, tokens, cache)
    cache = KC.advance(geom, cache)
    logits, cache = T.paged_decode_step(cfg, params, tokens, cache, geom)
    return logits, KC.commit_token(cache)


def make_serve_step(cfg: ModelConfig, geom):
    """``serve_step`` with the model and geometry bound: ``step(params,
    tokens, cache) -> (logits, cache)``."""
    return functools.partial(serve_step, cfg, geom)


# ---------------------------------------------------------------------------
# prefill — fills pools page-contiguously and registers mappings
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, geom: KC.PageGeometry, params: dict,
            inputs: torch.Tensor, cache: KC.PagedCache,
            prompt_len: Optional[int] = None):
    """Run the full-attention forward over prompts and populate the paged
    cache. ``inputs``: (B, S) tokens or (B, S, E) embeds; S must be a
    multiple of page_size for the bulk page fill (pad upstream).

    Under a mesh ``inputs`` are the global batch's, ``geom`` and ``cache``
    this rank's shard (``kvcache.shard_cache``): the forward runs under the
    model's tensor-parallel annotations, each rank fills its sequences'
    pages with its slice of each page's tokens and inserts their mappings
    into its own page tables.

    Returns (last-position logits (B, V), cache); under a mesh the logits
    are the full tensor on every rank."""
    T._require_paged(cfg)
    DS, Bl, PS = geom.shards, geom.batch_per_shard, geom.page_size
    S = inputs.shape[1]
    if S % PS:
        raise ValueError(f"prompt length {S} is not a multiple of the page "
                         f"size {PS}")
    npages = S // PS
    KVH = geom.kv_heads
    off, PSl = geom.token_offset, geom.slice_tokens
    dev = cache.kpool.device
    sharded = SH.get_mesh() is not None

    # deterministic physical layout for prompt pages: seq-major
    phys = (torch.arange(Bl * npages, dtype=I32, device=dev)
            .reshape(1, Bl, npages).expand(DS, Bl, npages)) % geom.pool_pages
    pf = phys.reshape(DS, Bl * npages).long()

    def page_major(t):       # (B, S, KVH, X) -> (DS, Bl * NP, KVH, PSl, X)
        t = t.reshape(DS, Bl, npages, PS, KVH, t.shape[-1])
        t = t[:, :, :, off:off + PSl].movedim(3, 4)   # this rank's slice
        return t.reshape(DS, Bl * npages, KVH, PSl, t.shape[-1])

    def put(pool, pages):    # one layer's pool (DS, NPl, ...) <- pages
        for s in range(DS):
            pool[s, pf[s]] = pages[s]

    with SH.mesh_context():
        if sharded:
            inputs = shard(inputs, "batch", *(None,) * (inputs.dim() - 1))
        x = shard(T.embed(cfg, params, inputs), "batch", "seq", "embed")
        positions = torch.arange(S, device=dev)[None]
        for layer in range(cfg.n_layers):
            p = T.layer_params(params, layer)
            h = L.apply_norm(cfg, p, "ln1", x)
            attn, (k, v) = T._attn_heads(cfg, p, h, positions, cfg.window)
            x = x + shard(attn @ p["wo"].to(x.dtype), "batch", "seq", "embed")
            x = x + T.ffn(cfg, p, L.apply_norm(cfg, p, "ln2", x))[0]
            if sharded:      # this rank's sequences, every kv head
                k, v = T._batch_local(k), T._batch_local(v)
            # bulk page fill: (B,S,KVH,D) -> (DS,Bl*NP,KVH,PSl,D) -> pool
            for pools, scales, kv in ((cache.kpool, cache.kscale, k),
                                      (cache.vpool, cache.vscale, v)):
                if scales is not None:   # int8: quantized, with its scales
                    kv, sc = KC.quant_store(kv)
                    put(scales[layer], page_major(sc))
                put(pools[layer], page_major(kv).to(pools.dtype))
        x = T.final_norm(cfg, params, x)
        logits = SH.gather(T.logits_fn(cfg, params, x[:, -1]))

    # register page mappings (server-side batched inserts via the store)
    pages = torch.arange(npages, dtype=I32, device=dev).expand(Bl, npages)
    if dev.type != "meta":            # meta: shapes only (launch.dryrun)
        for s in range(DS):
            keys = KC.page_keys(
                cache.seq_ids[s][:, None].expand(Bl, npages), pages)
            geom.store.insert(cache.table[s], keys.reshape(-1, 4),
                              KC.page_values(phys[s]).reshape(-1, 4))

    plen = prompt_len if prompt_len is not None else S

    def full(shape, value):
        return torch.full(shape, value, dtype=I32, device=dev)

    cache = cache._replace(
        next_free=full((DS,), Bl * npages % geom.pool_pages),
        seq_lens=full((DS, Bl), plen),
        cur_page=phys[:, :, -1].contiguous(),
        cur_off=full((DS, Bl), plen % PS))
    return logits, cache


# ---------------------------------------------------------------------------
# sequence lifecycle (host-orchestrated, device-executed)
# ---------------------------------------------------------------------------

def release_sequence(geom: KC.PageGeometry, cache: KC.PagedCache,
                     shard_idx: int, slot: int) -> KC.PagedCache:
    """Finish a sequence: delete its page mappings (1 PM write each — the
    paper's atomic deletion) and recycle the slot for a new request."""
    seq = cache.seq_ids[shard_idx, slot]
    npages = (cache.seq_lens[shard_idx, slot] + geom.page_size - 1) \
        // geom.page_size
    pages = torch.arange(geom.max_pages, dtype=I32, device=seq.device)
    keys = KC.page_keys(seq.expand(geom.max_pages), pages)
    # delete only the mapped pages (masked batch keeps PM-write accounting)
    geom.store.delete(cache.table[shard_idx], keys, pages < npages)

    def put(t, value):
        t = t.clone()
        t[shard_idx, slot] = value
        return t

    return cache._replace(
        seq_ids=put(cache.seq_ids, cache.seq_ids.max() + 1),
        seq_lens=put(cache.seq_lens, 0),
        cur_page=put(cache.cur_page, 0),
        cur_off=put(cache.cur_off, 0))


# ---------------------------------------------------------------------------
# content-addressed prefix sharing (hash-index-native feature)
# ---------------------------------------------------------------------------

def content_page_keys(tokens: torch.Tensor, page_size: int) -> torch.Tensor:
    """Rolling content hashes per page: key_p = H(key_{p-1}, tokens of page p)
    — identical prompt prefixes yield identical page keys across requests,
    so the hash table maps them to ONE shared physical page.  Returns
    (B, npages, 4) int32 key words."""
    B, S = tokens.shape
    npages = S // page_size
    tp = tokens[:, :npages * page_size].reshape(B, npages, page_size)
    ph = fold_u32(tp)                                        # (B, npages)
    h = torch.zeros(B, dtype=torch.int64, device=tokens.device)
    chained = []
    for p in range(npages):
        h = mix_pair(h, ph[:, p])
        chained.append(h)
    chained = torch.stack(chained, 1)                        # (B, npages)
    pages = torch.arange(npages, device=tokens.device).expand(B, npages)
    return to_i32(torch.stack([chained, pages, chained ^ pages,
                               torch.full_like(chained, CONTENT_SALT)], -1))
