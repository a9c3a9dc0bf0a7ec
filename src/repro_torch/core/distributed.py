"""Distributed continuity KV store over a device mesh.

Port of ``repro.core.distributed``.  The reference runs one ``shard_map``
program over the mesh; here every rank runs the same functions on its own
shard and its own client batch, and the reference's collectives become
``torch.distributed`` calls on the group of the store's mesh axes (NCCL
for CUDA tensors, gloo for CPU ones):

  * the table's segment pairs are block-partitioned over the store axes:
    rank ``s`` of the group holds pairs ``[s * P_l, (s + 1) * P_l)`` as a
    local table of ``pairs_per_shard`` pairs (``create_sharded``), one
    "server" with its "PM region";
  * CLIENT READS (paper §III-B): each rank routes its batch's (pair,
    parity) requests to the owners with ONE ``all_to_all_single``; owners
    answer with the RAW pair row (keys, values, indicator) in a second;
    the client probes locally (one-sided read semantics, one segment per
    lookup on the wire);
  * SERVER WRITES: insert / update / delete requests are routed to the
    owners, applied one entry at a time in the order received (source
    rank, then the batch order within it: lock order = batch order), and
    acknowledged in the return ``all_to_all_single``.  The owner's walk is
    the serial-walk kernel's routed mode on a card (``kernels.scan_walk``).

Routing uses fixed per-destination capacity buckets (equal, contiguous
``all_to_all_single`` splits); overflowing keys are reported for retry,
the RDMA analogue of a full send queue.  Words ride in int32 tensors with
the reference's uint32 bits; the live mask travels as one more word.

As the reference does, the owner's write path bumps ``version`` with the
indicator commit and never writes the fingerprint word, and the table's
``count`` is not maintained across shards (``sharded_count`` counts the
indicator bits).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import continuity as ch
from repro_torch.core import pmem
from repro_torch.core.continuity import (FP_BYTES, INDICATOR_BYTES,
                                         KEY_LANES, SLOT_BYTES, VAL_LANES,
                                         ContinuityConfig, ContinuityTable,
                                         _probe_tensor, locate)
from repro_torch.core.hashfn import hash128
from repro_torch.core.words import as_words, popcount, to_i32, u32
from repro_torch.kernels import scan_walk as SW
from repro_torch.rdma import verbs as rv

I32 = torch.int32
I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    table: ContinuityConfig       # GLOBAL table geometry
    num_shards: int               # servers (= product of sharded axes)
    capacity_factor: float = 2.0  # routing bucket headroom
    axis_names: tuple = ("data",)  # mesh axes the store shards over

    def __post_init__(self):
        if self.table.num_pairs % self.num_shards:
            raise ValueError(f"{self.table.num_pairs} pairs do not split "
                             f"into {self.num_shards} shards")
        if self.table.ext_frac != 0.0:
            raise ValueError("the distributed store uses ext-free tables")

    @property
    def pairs_per_shard(self) -> int:
        return self.table.num_pairs // self.num_shards

    @property
    def local_cfg(self) -> ContinuityConfig:
        return dataclasses.replace(self.table,
                                   num_buckets=2 * self.pairs_per_shard)

    def cap(self, batch_per_shard: int) -> int:
        c = int(batch_per_shard / self.num_shards * self.capacity_factor) + 1
        return min(c, batch_per_shard)


def create_sharded(cfg: StoreConfig, device="cuda") -> ContinuityTable:
    """This rank's shard: an empty local table of ``pairs_per_shard`` pairs
    (the reference's global table cut on dim 0 by ``table_pspec``)."""
    return ch.create(cfg.local_cfg, device)


def table_pspec(axes=("data",)) -> ContinuityTable:
    """Per leaf, the mesh axes of each dim: pair-indexed leaves shard dim 0
    over the store axes; the (unused, ext-free) extension pool, the
    scalar counters and the stash stay replicated."""
    d, r = (tuple(axes),), ()
    return ContinuityTable(keys=d, vals=d, indicator=d, version=d,
                           ext_keys=r, ext_vals=r, ext_map=d,
                           ext_count=r, count=r, fp=d,
                           stash_keys=r, stash_vals=r, stash_meta=r)


def store_group(cfg: StoreConfig, mesh):
    """The process group over ``cfg.axis_names`` of ``mesh`` that holds
    this rank (group rank = shard index, in the axes' major-to-minor
    order); checks that it has ``num_shards`` ranks."""
    axes = tuple(cfg.axis_names)
    sub = mesh[axes] if len(axes) > 1 else mesh[axes[0]]
    if len(axes) > 1:
        sub = sub._flatten()
    group = sub.get_group()
    if dist.get_world_size(group) != cfg.num_shards:
        raise ValueError(f"the mesh axes {axes} hold "
                         f"{dist.get_world_size(group)} ranks, the store "
                         f"{cfg.num_shards} shards")
    return group


def sharded_count(table: ContinuityTable, group=None) -> torch.Tensor:
    """Live items from indicator popcounts over every shard (the count
    scalar is not maintained across shards): a 0-d int64 tensor."""
    n = popcount(u32(table.indicator)).sum()
    dist.all_reduce(n, group=group)
    return n


def _route(cfg: StoreConfig, payload, owner, mask, group):
    """Scatter ``payload`` (B, F) words into per-destination capacity
    buckets and all_to_all them.  Returns (recv (S, CAP, F), its live
    mask (S, CAP), the bookkeeping for ``_route_back``)."""
    B = owner.shape[0]
    S = cfg.num_shards
    CAP = cfg.cap(B)
    dev = payload.device
    # rank of each key within its destination bucket (batch order)
    onehot = (owner[:, None] == torch.arange(S, device=dev)[None]) \
        & mask[:, None]
    rank = torch.cumsum(onehot.to(I64), 0) - 1
    rank = (rank * onehot).sum(1)                          # (B,)
    ok = mask & (rank < CAP)
    # rows that are not routed land in a spare bucket entry, cut off below
    # (the reference's mode="drop"; no data-dependent shapes)
    o = torch.where(ok, owner, S)
    r = torch.where(ok, rank, CAP)
    send = torch.zeros((S + 1, CAP + 1, payload.shape[1] + 1), dtype=I32,
                       device=dev)
    send[o, r, :-1] = payload
    send[o, r, -1] = 1                                     # the live word
    send = send[:S, :CAP].contiguous()
    recv = torch.zeros_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv[..., :-1], recv[..., -1] == 1, (owner, rank, ok)


def _route_back(cfg: StoreConfig, reply, route_meta, group):
    """Inverse all_to_all + gather each key's reply back to its batch
    slot (rows that were not routed read the last bucket entry)."""
    owner, rank, ok = route_meta
    back = torch.empty_like(reply)
    dist.all_to_all_single(back, reply.contiguous(), group=group)
    safe_o = torch.where(ok, owner, cfg.num_shards - 1)
    safe_r = torch.where(ok, rank, back.shape[1] - 1)
    return back[safe_o, safe_r], ok


class DLookupResult(NamedTuple):
    found: torch.Tensor      # (B,) bool
    values: torch.Tensor     # (B, VAL_LANES) int32 words
    routed: torch.Tensor     # (B,) bool; False = routing overflow, retry
    ledger: pmem.CostLedger  # GLOBAL client-batch wire ledger (verb-plan-
    #                          derived, all-reduced over the store group)


def _client_probe(cfg: ContinuityConfig, seg_keys, seg_vals, indicator,
                  parity, qkeys, live):
    """Client-side probe of fetched rows (one per query) over its
    segment's slots in probe order."""
    probe = _probe_tensor(cfg, qkeys.device)[:, :cfg.seg_slots]
    cand = probe[parity]                                   # (B, C)
    bits = (u32(indicator)[:, None] >> cand) & 1
    ck = torch.gather(seg_keys, 1, cand[..., None].expand(-1, -1, KEY_LANES))
    cv = torch.gather(seg_vals, 1, cand[..., None].expand(-1, -1, VAL_LANES))
    match = (bits == 1) & (ck == qkeys[:, None, :]).all(-1) & live[:, None]
    found = match.any(-1)
    first = torch.argmax(match.to(torch.int8), -1)
    vals = cv[torch.arange(cv.shape[0], device=cv.device), first]
    return found, torch.where(found[:, None], vals, 0)


def _ledger(pair, ok, row_bytes, group) -> pmem.CostLedger:
    """The batch's wire ledger: one whole-row READ per routed key (the
    verb plan the local stores use), summed over the store group."""
    B = pair.shape[0]
    plan = rv.pack(B, [(torch.where(ok, rv.READ, rv.NOOP), rv.REGION_TABLE,
                        pair * row_bytes, row_bytes, 0, False)],
                   device=pair.device)
    led = rv.ledger_from_plan(plan)._replace(ops=ok.sum().to(I64))
    flat = torch.stack(list(led))
    dist.all_reduce(flat, group=group)
    return pmem.CostLedger(*flat.unbind(0))


def make_lookup(cfg: StoreConfig, mesh):
    """The distributed lookup of this rank: ``lookup(table, keys, mask)``
    with ``table`` the rank's shard and ``keys`` (B, 4) its client batch
    (the reference's dim-0 split) -> ``DLookupResult`` of that batch.
    Retry unrouted keys with an updated ``mask`` (ranks are deterministic,
    so identical batches overflow identically)."""
    group = store_group(cfg, mesh)
    Ppairs = cfg.pairs_per_shard
    SL = cfg.table.slots_per_pair
    row_bytes = INDICATOR_BYTES + FP_BYTES + SL * SLOT_BYTES

    def lookup(table: ContinuityTable, keys, mask=None):
        dev = table.keys.device
        keys = as_words(keys, KEY_LANES, dev)
        B = keys.shape[0]
        mask = (torch.ones(B, dtype=torch.bool, device=dev) if mask is None
                else torch.as_tensor(mask, device=dev).bool())
        pair, parity = locate(cfg.table, keys)              # GLOBAL pair ids
        req = torch.stack([pair, parity], 1).to(I32)
        recv, _, meta = _route(cfg, req, pair // Ppairs, mask, group)

        # owner side: the raw pair rows (NO probing: a one-sided read)
        lp = recv[..., 0].to(I64) % Ppairs
        S, CAP = lp.shape
        reply = torch.cat([table.keys[lp].reshape(S, CAP, SL * KEY_LANES),
                           table.vals[lp].reshape(S, CAP, SL * VAL_LANES),
                           table.indicator[lp][..., None]], -1)
        out, ok = _route_back(cfg, reply, meta, group)

        # client side: local probe of the fetched row
        rkeys = out[:, :SL * KEY_LANES].reshape(B, SL, KEY_LANES)
        rvals = out[:, SL * KEY_LANES:SL * (KEY_LANES + VAL_LANES)] \
            .reshape(B, SL, VAL_LANES)
        found, vals = _client_probe(cfg.table, rkeys, rvals, out[:, -1],
                                    parity, keys, ok)
        return DLookupResult(found, vals, ok,
                             _ledger(pair, ok, row_bytes, group))
    return lookup


OP_INSERT, OP_UPDATE, OP_DELETE = 1, 2, 3


def make_write(cfg: StoreConfig, mesh):
    """The distributed write of this rank: ``write(table, op, keys, vals)``
    with ``op`` (B,) in {0 (none), OP_INSERT, OP_UPDATE, OP_DELETE} ->
    ``(table, ok (B,), routed (B,))``; the rank's shard is updated in
    place with what the other ranks routed to it."""
    group = store_group(cfg, mesh)
    Ppairs = cfg.pairs_per_shard
    lcfg = cfg.local_cfg
    KL, VL = KEY_LANES, VAL_LANES

    def write(table: ContinuityTable, op, keys, vals):
        dev = table.keys.device
        keys = as_words(keys, KL, dev)
        vals = as_words(vals, VL, dev)
        op = torch.as_tensor(op, device=dev).to(I32).reshape(-1)
        pair, parity = locate(cfg.table, keys)
        req = torch.cat([torch.stack([pair, parity], 1).to(I32), op[:, None],
                         keys, vals], 1)
        recv, rlive, meta = _route(cfg, req, pair // Ppairs, op > 0, group)
        S, CAP, F = recv.shape
        flat = recv.reshape(S * CAP, F)
        status = SW.routed_write(
            lcfg, table, (flat[:, 0].to(I64) % Ppairs).to(I32),
            flat[:, 1].contiguous(), flat[:, 2].contiguous(),
            flat[:, 3:3 + KL].contiguous(),
            flat[:, 3 + KL:3 + KL + VL].contiguous(), rlive.reshape(S * CAP))
        out, ok = _route_back(cfg, status.reshape(S, CAP, 1), meta, group)
        return table, (out[:, 0] == 1) & ok, ok
    return write


# ---------------------------------------------------------------------------
# level-hashing-style distributed lookup (for the access-amplification
# comparison at pod scale)
# ---------------------------------------------------------------------------

def make_lookup_multifetch(cfg: StoreConfig, mesh, fetches: int = 4):
    """A lookup that must fetch ``fetches`` NON-CONTIGUOUS candidate rows
    per key (level hashing's four buckets / CCEH's directory + bucket),
    issued in parallel like independent one-sided reads.  Rows come from
    independent hashes; the reply payload is one BUCKET row (a quarter
    row) per fetch, and a hit is a key match in it (no indicator check,
    as in the reference).  It measures the collective-term difference;
    it is not a functional store.  Returns ``found`` (B,)."""
    group = store_group(cfg, mesh)
    Ppairs = cfg.pairs_per_shard
    SL = cfg.table.slots_per_pair
    Q = SL // 4

    def lookup(table: ContinuityTable, keys, mask=None):
        dev = table.keys.device
        keys = as_words(keys, KEY_LANES, dev)
        B = keys.shape[0]
        mask = (torch.ones(B, dtype=torch.bool, device=dev) if mask is None
                else torch.as_tensor(mask, device=dev).bool())
        found = torch.zeros(B, dtype=torch.bool, device=dev)
        for f in range(fetches):
            h = hash128(keys, seed=(0x9E3779B9 * (f + 1)) & 0xFFFFFFFF)
            pair = h % cfg.table.num_pairs
            recv, _, meta = _route(cfg, to_i32(pair)[:, None], pair // Ppairs,
                                   mask, group)
            lp = recv[..., 0].to(I64) % Ppairs
            S, CAP = lp.shape
            reply = torch.cat(
                [table.keys[lp][..., :Q, :].reshape(S, CAP, -1),
                 table.vals[lp][..., :Q, :].reshape(S, CAP, -1),
                 table.indicator[lp][..., None]], -1)
            out, ok = _route_back(cfg, reply, meta, group)
            rk = out[:, :Q * KEY_LANES].reshape(B, Q, KEY_LANES)
            found |= (rk == keys[:, None, :]).all(-1).any(-1) & ok
        return found
    return lookup
