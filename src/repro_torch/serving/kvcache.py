"""Paged KV cache whose page table is a continuity hash store.

Port of ``repro.serving.kvcache``.  The physical KV pool is a fixed set of
pages per data shard; the logical->physical mapping (sequence_id,
logical_page) -> physical_page lives in one hash-store table per shard
behind the ``repro_torch.api`` store protocol.  Lookups on the decode hot
path are the paper's client reads (ONE contiguous segment fetch per page
translation, through the segment-probe kernel on a card); page allocation
is the server-side insert with its indicator commit.

Layout: pools (L, DS, NPl, KVH, PS, D); ``table`` is a tuple of DS store
tables (the reference stacks them on a leading DS dim and vmaps the
store).  Write paths update the pools and the tables IN PLACE (a copy per
step would move the whole pool); the small per-sequence fields
(``next_free``, ``seq_ids``, ``seq_lens``, ``cur_page``, ``cur_off``) are
replaced, as in the reference.  Word fields (``seq_ids``, keys, values)
are int32 tensors holding the reference's uint32 bits.

``step_read_plan`` is the verb plan of one decode step's translations
(what the batcher posts to a simulated transport); ``open_new_pages_traced``
is the crash-checkable twin of the page allocation.

``create_state_cache`` is the cache of the ssm and hybrid families
(recurrent state, conv windows, hybrid's ring buffers and global linear
caches); those families never touch the page table.

Under a mesh (``distribution.sharding.use_mesh``) each rank holds its
shard of the cache, as the reference's ``cache_logical_axes`` places it:
the pools' DS dim over the data axes, each page's tokens over the model
axis ("split-KV"), kv heads replicated; the page tables, ``next_free``
and the sequence fields of its data shards, replicated over the model
axis.  ``shard_cache`` cuts a global cache into the rank's shard (and a
geometry of its data shards and page-token slice), ``gather_cache``
gathers the shards back.  Every rank of a data group keeps its copy of
the page tables with the same upkeep (``advance`` on its own tables), so
the copies stay byte-equal with no collective.  On meta tensors (the
planning tools' dry run) the page-table upkeep gives shapes only.

``kv_dtype="int8"`` stores the pools as int8 with one float32 scale per
(token, head) in ``kscale``/``vscale`` (``quant_store``/``dequant``, the
reference's arithmetic); the decode step attends over them with the
paged-attention kernel's int8 mode.  ``merged_attn`` selects the
reference's legacy decode path (pages gathered and merged into one
token range, plain attention); it launches no attention kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import ExecPolicy, make_store
from repro_torch.core.words import resolve_device
from repro_torch.kernels.paged_attn_ref import dequant, quant_store  # noqa: F401
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.rdma import verbs as rv

I32 = torch.int32
PAGE_SALT = 0xC0FFEE01
_SALT_WORD = PAGE_SALT - (1 << 32)     # the same bits as an int32 word


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    layers: int
    kv_heads: int
    head_dim: int
    page_size: int
    max_pages: int            # logical pages per sequence
    shards: int               # DS (data shards)
    batch_per_shard: int
    pool_pages: int           # NPl physical pages per shard
    kv_dtype: str             # float32 | bfloat16 | float16 | int8
    store: Any                # repro_torch.api store: the page-table backend
    # the reference's legacy decode path: pages gathered and merged
    # (MAXP, PS) -> T before a plain attention (no attention kernel)
    merged_attn: bool = False
    # under a mesh (``shard_cache``): each page's tokens split into
    # ``page_slices`` slices over the model axis, this rank's the
    # ``page_slice``-th; ``shards`` then counts this rank's data shards
    page_slices: int = 1
    page_slice: int = 0

    @property
    def batch(self) -> int:
        return self.shards * self.batch_per_shard

    @property
    def slice_tokens(self) -> int:
        """Tokens of each page that this rank's pools hold."""
        return self.page_size // self.page_slices

    @property
    def token_offset(self) -> int:
        """The first of them: local row j of a page is token offset + j."""
        return self.page_slice * self.slice_tokens

    @property
    def device(self) -> torch.device:
        return torch.device(self.store.device)


def page_table_slots(geom_entries: int, load: float = 0.5) -> int:
    """Storage units a page-table store needs for ``geom_entries``
    mappings/shard at target ``load``."""
    return int(np.ceil(geom_entries / load))


def make_geometry(cfg: ModelConfig, shape: ShapeConfig, shards: int,
                  page_size: int = 512, oversub: float = 1.0,
                  kv_dtype: Optional[str] = None,
                  merged_attn: bool = False,
                  scheme: str = "continuity",
                  policy: Optional[ExecPolicy] = None,
                  device: str = "cuda") -> PageGeometry:
    """Geometry of a paged cache for ``shape`` on ``device`` (CUDA unless
    the caller asks for the CPU); the store's default policy runs the
    segment kernels."""
    if shape.global_batch % shards:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {shards} shards")
    kv_dtype = kv_dtype or cfg.kv_quant.replace("none", cfg.dtype)
    device = resolve_device(device)
    bl = shape.global_batch // shards
    maxp = (shape.seq_len + page_size - 1) // page_size
    pool = max(1, int(np.ceil(bl * maxp * oversub)))
    store = make_store(scheme, table_slots=page_table_slots(bl * maxp),
                       policy=policy or ExecPolicy(), device=device)
    return PageGeometry(
        layers=cfg.n_layers, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        page_size=page_size, max_pages=maxp, shards=shards,
        batch_per_shard=bl, pool_pages=pool, kv_dtype=kv_dtype, store=store,
        merged_attn=merged_attn)


class PagedCache(NamedTuple):
    kpool: torch.Tensor         # (L, DS, NPl, KVH, PS, D) kv_dtype
    vpool: torch.Tensor
    kscale: Optional[torch.Tensor]  # (L, DS, NPl, KVH, PS, 1) f32 when int8
    vscale: Optional[torch.Tensor]
    table: Tuple[Any, ...]      # DS store tables
    next_free: torch.Tensor     # (DS,) int32 — physical page bump allocator
    seq_ids: torch.Tensor       # (DS, Bl) int32 words: global sequence ids
    seq_lens: torch.Tensor      # (DS, Bl) int32 tokens already cached
    cur_page: torch.Tensor      # (DS, Bl) int32 physical id of open page
    cur_off: torch.Tensor       # (DS, Bl) int32 write offset in open page


def pool_shape(g: PageGeometry):
    return (g.layers, g.shards, g.pool_pages, g.kv_heads, g.page_size,
            g.head_dim)


def create_cache(g: PageGeometry) -> PagedCache:
    dev = g.device
    DS, Bl = g.shards, g.batch_per_shard

    def zeros(*shape):
        return torch.zeros(shape, dtype=I32, device=dev)

    dt = getattr(torch, g.kv_dtype)
    quant = g.kv_dtype == "int8"

    def scales():
        return (torch.zeros(pool_shape(g)[:-1] + (1,), dtype=torch.float32,
                            device=dev) if quant else None)
    return PagedCache(
        kpool=torch.zeros(pool_shape(g), dtype=dt, device=dev),
        vpool=torch.zeros(pool_shape(g), dtype=dt, device=dev),
        kscale=scales(), vscale=scales(),
        table=tuple(g.store.create() for _ in range(DS)),
        next_free=zeros(DS),
        seq_ids=torch.arange(DS * Bl, dtype=I32, device=dev).reshape(DS, Bl),
        seq_lens=zeros(DS, Bl), cur_page=zeros(DS, Bl), cur_off=zeros(DS, Bl))


def _stacked_axes(table: Any, axis: str):
    """Logical axes of one shard's store table as the reference stacks it
    (a leading shard dim on every leaf): ``(axis, None, ..., None)``."""
    return type(table)(*((axis,) + (None,) * leaf.dim() for leaf in table))


def cache_logical_axes(g: PageGeometry, cache: PagedCache):
    """Logical-axis tree matching ``cache`` (see distribution.sharding);
    ``table`` holds the axes of the reference's stacked (DS, ...) table."""
    pool_ax = ("layers", "kv_shard", None, "kv_heads_dec", "page_tokens", None)
    return PagedCache(
        kpool=pool_ax, vpool=pool_ax,
        kscale=None if cache.kscale is None else pool_ax[:-1] + (None,),
        vscale=None if cache.vscale is None else pool_ax[:-1] + (None,),
        table=_stacked_axes(cache.table[0], "kv_shard"),
        next_free=("kv_shard",),
        seq_ids=("kv_shard", None), seq_lens=("kv_shard", None),
        cur_page=("kv_shard", None), cur_off=("kv_shard", None),
    )


def _local_chunk(t: torch.Tensor, names, mesh) -> torch.Tensor:
    """This rank's chunk of ``t`` placed by logical ``names``, copied."""
    from repro_torch.distribution.sharding import chunk_of, logical_spec
    spec = logical_spec(*names, size_of=tuple(t.shape))
    for d, entry in enumerate(spec):
        idx, count = chunk_of(entry, mesh)
        n = t.shape[d] // count
        t = t.narrow(d, idx * n, n)
    return t.clone(memory_format=torch.contiguous_format)


def shard_cache(g: PageGeometry, cache: PagedCache):
    """This rank's shard of a global cache under the active mesh
    (``distribution.sharding.use_mesh``), placed by ``cache_logical_axes``:
    the pools (L, DS/d, NPl, KVH, PS/m, D) (and the int8 scales alike), the
    page tables and sequence fields of its DS/d data shards, every tensor a
    copy.  Returns (local geometry, local cache): ``shards`` DS/d, the
    page-token slice (``page_slices`` m, ``page_slice`` this rank's model
    coordinate).  Where PS does not divide by the model extent the pools'
    page-token dim stays replicated (``logical_spec``'s rule) and the rank
    reads whole pages; kv heads stay replicated (``kv_heads_dec``)."""
    from repro_torch.distribution.sharding import (chunk_of, get_mesh,
                                                   logical_spec)
    mesh = get_mesh()
    if mesh is None:
        raise ValueError("shard_cache runs under distribution.sharding."
                         "use_mesh")
    ax = cache_logical_axes(g, cache)
    pool_spec = logical_spec(*ax.kpool, size_of=tuple(cache.kpool.shape))
    ds_idx, d = chunk_of(pool_spec[1], mesh)
    if g.shards % d:
        raise ValueError(f"{g.shards} data shards do not split over {d} "
                         f"data ranks")
    r, m = chunk_of(pool_spec[4], mesh)
    ds = g.shards // d
    lg = dataclasses.replace(g, shards=ds, page_slices=m, page_slice=r)

    def chunk(t, names):
        return None if t is None else _local_chunk(t, names, mesh)
    table = tuple(type(t)(*(x.clone() for x in t))
                  for t in cache.table[ds_idx * ds:(ds_idx + 1) * ds])
    return lg, PagedCache(
        kpool=chunk(cache.kpool, ax.kpool), vpool=chunk(cache.vpool, ax.vpool),
        kscale=chunk(cache.kscale, ax.kscale),
        vscale=chunk(cache.vscale, ax.vscale), table=table,
        **{f: chunk(getattr(cache, f), getattr(ax, f))
           for f in ("next_free", "seq_ids", "seq_lens", "cur_page",
                     "cur_off")})


def gather_cache(g: PageGeometry, local: PagedCache) -> PagedCache:
    """The inverse of ``shard_cache`` under the active mesh: the global
    cache of geometry ``g`` (the global one) from every rank's shard, on
    every rank (collectives over the mesh; for checks).  Replicated fields
    are taken from each rank's own copy."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distribution.sharding import (get_mesh, logical_spec,
                                                   placements)
    mesh = get_mesh()
    ax = cache_logical_axes(g, local)
    DS, Bl = g.shards, g.batch_per_shard
    pool = pool_shape(g)
    shapes = dict(kpool=pool, vpool=pool, kscale=pool[:-1] + (1,),
                  vscale=pool[:-1] + (1,), next_free=(DS,), seq_ids=(DS, Bl),
                  seq_lens=(DS, Bl), cur_page=(DS, Bl), cur_off=(DS, Bl))

    def full(t, names, shape):
        if t is None:
            return None
        shape = torch.Size(shape)
        pl = placements(logical_spec(*names, size_of=tuple(shape)), mesh)
        return DTensor.from_local(
            t.contiguous(), mesh, pl, run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride()).full_tensor()
    t0 = local.table[0]
    leaves = []
    for f in t0._fields:
        x = torch.stack([getattr(t, f) for t in local.table])
        leaves.append(full(x, ("kv_shard",) + (None,) * (x.dim() - 1),
                           (DS,) + tuple(x.shape[1:])))
    table = tuple(type(t0)(*(x[s] for x in leaves)) for s in range(DS))
    return PagedCache(table=table, **{
        f: full(getattr(local, f), getattr(ax, f), shapes[f])
        for f in shapes})


# -- page-key construction ---------------------------------------------------

def page_keys(seq_ids: torch.Tensor, logical_pages: torch.Tensor) -> torch.Tensor:
    """(...,) ids + pages -> (..., 4) int32 hash-key words."""
    s = seq_ids.to(I32)
    p = logical_pages.to(I32)
    salt = torch.full_like(s, _SALT_WORD)
    return torch.stack([s, p, s ^ p, salt], dim=-1)


def page_values(phys: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(phys, dtype=I32)
    return torch.stack([phys.to(I32), z, z, z], dim=-1)


# -- the paper's ops on the decode path --------------------------------------

def _translation_keys(g: PageGeometry, seq_ids: torch.Tensor) -> torch.Tensor:
    """(DS, Bl*MAXP, 4) page-table keys for every (sequence, logical page)
    candidate translation of one decode step."""
    DS, Bl = seq_ids.shape
    pages = torch.arange(g.max_pages, dtype=I32, device=seq_ids.device)
    keys = page_keys(seq_ids[..., None].expand(DS, Bl, g.max_pages),
                     pages.expand(DS, Bl, g.max_pages))
    return keys.reshape(DS, Bl * g.max_pages, 4)


def lookup_pages(g: PageGeometry, table, seq_ids: torch.Tensor) -> torch.Tensor:
    """Translate every (sequence, logical page) via a store lookup — the
    paper's client read (for continuity: one contiguous segment fetch per
    translation). Returns (DS, Bl, MAXP) int32 physical ids, -1 where
    unmapped."""
    DS, Bl = seq_ids.shape
    if seq_ids.device.type == "meta":   # shapes only (launch.dryrun)
        return torch.empty((DS, Bl, g.max_pages), dtype=I32, device="meta")
    keys = _translation_keys(g, seq_ids)
    phys = []
    for s in range(DS):
        res = g.store.lookup(table[s], keys[s])
        phys.append(torch.where(res.ok, res.values[:, 0], -1))
    return torch.stack(phys).reshape(DS, Bl, g.max_pages)


def step_read_plan(g: PageGeometry, cache: PagedCache):
    """One decode step's page-translation verb plan, all shards flattened:
    one one-sided READ per (sequence, logical page) candidate translation,
    the same keys `lookup_pages` resolves.  The batcher posts it to its
    transport with ONE doorbell per step (the flush boundary).  The
    post-step cache is the right input: its table is the one the step's
    reads resolved against (``commit_token`` only bumps ``seq_lens``).
    One extra (plan-only) lookup per step, so it is opt-in via the
    transport."""
    keys = _translation_keys(g, cache.seq_ids)
    plans = [g.store.lookup(cache.table[s], keys[s]).plan
             for s in range(g.shards)]
    return rv.flatten(rv.VerbPlan(*(torch.stack(leaves)
                                    for leaves in zip(*plans))))


def flat_page_table(g: PageGeometry, page_table: torch.Tensor) -> torch.Tensor:
    """(DS, Bl, MAXP) per-shard page ids -> (B, MAXP) ids into the pool
    viewed as (DS*NPl, ...): shard s's ids are offset by s*NPl, -1 stays
    -1."""
    DS = page_table.shape[0]
    base = (torch.arange(DS, dtype=I32, device=page_table.device)
            * g.pool_pages)[:, None, None]
    flat = torch.where(page_table >= 0, page_table + base, -1)
    return flat.reshape(-1, page_table.shape[-1]).to(I32).contiguous()


def _plan_page_allocation(g: PageGeometry, cache: PagedCache,
                          need: torch.Tensor):
    """Shared allocation prologue: physical ids (bump allocator, alloc
    order, +wrap) and the (seq, page) -> phys mapping batch."""
    rank = torch.cumsum(need.to(I32), dim=1) - 1              # alloc order
    phys = (cache.next_free[:, None] + rank) % g.pool_pages   # bump (+wrap)
    logical = torch.div(cache.seq_lens, g.page_size, rounding_mode="floor")
    keys = page_keys(cache.seq_ids, logical)                  # (DS, Bl, 4)
    return phys.to(I32), keys, page_values(phys)


def _open_pages_epilogue(cache: PagedCache, need, phys) -> PagedCache:
    """Shared epilogue: open the new pages."""
    return cache._replace(
        next_free=cache.next_free + need.sum(dim=1).to(I32),
        cur_page=torch.where(need, phys, cache.cur_page),
        cur_off=torch.where(need, 0, cache.cur_off).to(I32))


def open_new_pages(g: PageGeometry, cache: PagedCache,
                   need: torch.Tensor) -> PagedCache:
    """Allocate a physical page for each sequence with ``need`` set, insert
    the (seq, page) -> phys mapping into the hash table (server-side write:
    payload slots first, ONE atomic indicator commit), and open the page."""
    phys, keys, vals = _plan_page_allocation(g, cache, need)
    if need.device.type != "meta":     # meta: shapes only (launch.dryrun)
        for s in range(g.shards):
            g.store.insert(cache.table[s], keys[s], vals[s], need[s])
    return _open_pages_epilogue(cache, need, phys)


def open_new_pages_traced(g: PageGeometry, cache: PagedCache,
                          need: torch.Tensor):
    """Crash-checkable twin of `open_new_pages`: the same page-table insert
    per data shard, through ``store.trace_insert`` (the tables updated in
    place) — returns the updated cache plus one
    `repro_torch.consistency.TraceResult` per shard, whose PM store trace
    the crash injector can replay.  A host-level drill path, not the
    decode hot path."""
    phys, keys, vals = _plan_page_allocation(g, cache, need)
    traces = [g.store.trace_insert(cache.table[s], keys[s], vals[s],
                                   need[s])[1] for s in range(g.shards)]
    return _open_pages_epilogue(cache, need, phys), traces


def advance(g: PageGeometry, cache: PagedCache) -> PagedCache:
    """Pre-step bookkeeping: open a fresh page for sequences whose next token
    starts a new logical page."""
    need = (cache.seq_lens % g.page_size) == 0
    cache = open_new_pages(g, cache, need)
    return cache._replace(cur_off=cache.seq_lens % g.page_size)


def commit_token(cache: PagedCache) -> PagedCache:
    """Post-step: the new token is now cached."""
    return cache._replace(seq_lens=cache.seq_lens + 1)


# -- recurrent/window caches (ssm & hybrid families) --------------------------

def create_state_cache(cfg: ModelConfig, batch: int, max_seq: int,
                       dtype=torch.bfloat16, device="cuda") -> dict:
    """Cache for SSM (recurrent state) and hybrid (ring window + linear
    global caches + recurrent state) architectures, on ``device``: ``S``
    is float32, ``conv`` and the ring / global caches are ``dtype``."""
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    dev = resolve_device(device)
    d_inner, nheads, conv_ch = S.ssm_dims(cfg)
    s = cfg.ssm

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)
    cache = {
        "S": zeros((cfg.n_layers, batch, nheads, s.d_state, s.head_dim),
                   torch.float32),
        "conv": zeros((cfg.n_layers, batch, s.conv_width - 1, conv_ch), dtype),
        "seq_lens": zeros((batch,), I32),
    }
    if cfg.family == "hybrid":
        segs = T.layer_segments(cfg)
        n_win = sum(b - a for a, b, w in segs if w)
        n_glob = sum(b - a for a, b, w in segs if not w)
        KVH, D = cfg.n_kv_heads, cfg.hd
        cache.update(
            ring_k=zeros((n_win, batch, cfg.window, KVH, D), dtype),
            ring_v=zeros((n_win, batch, cfg.window, KVH, D), dtype),
            glob_k=zeros((n_glob, batch, max_seq, KVH, D), dtype),
            glob_v=zeros((n_glob, batch, max_seq, KVH, D), dtype),
        )
    return cache


def state_cache_logical_axes(cfg: ModelConfig, cache: dict) -> dict:
    ax = {
        "S": ("layers", "batch", "ssm_heads", None, None),
        "conv": ("layers", "batch", None, None),
        "seq_lens": ("batch",),
    }
    if "ring_k" in cache:
        win = ("layers", "batch", "page_tokens", "kv_heads_dec", None)
        ax.update(ring_k=win, ring_v=win, glob_k=win, glob_v=win)
    return ax
