"""P-FaRM-KV baseline in PyTorch: FaRM-KV's chained associative hopscotch
hashing (Dragojević et al., NSDI'14) made persistent with RECIPE (Lee et al.,
SOSP'19), as the paper's evaluation builds it (§V-A).

Port of ``repro.core.pfarm`` (the reference, unchanged).  N buckets of
``bucket_slots`` slots; a key with home bucket ``h`` lives in the contiguous
window ``h .. h+H-1`` (one one-sided read fetches it), else in an overflow
block chained to the home bucket (one more dependent read per hop).  An
insert into a full window tries ONE displacement before chaining.  RECIPE's
undo logging makes every mutation 5 PM writes (paper Table I: 5 / 5 / 5).

Differences from the reference, by design: the tables update in place;
the ``lax.scan`` write paths are the serial-walk kernel
(``kernels/scan_walk.py``; its per-op plain version on the CPU); plan
offsets are int64 (the reference's int32 ``home * bucket_stride`` wraps
past 2**31 bytes).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.continuity import KEY_LANES, SLOT_BYTES, VAL_LANES, _first
from repro_torch.core.hashfn import hash128
from repro_torch.core.level import token_bits
from repro_torch.core.words import as_words, resolve_device
from repro_torch.kernels.scan_walk import walk

I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8

PM_WRITES_PER_OP = 5  # RECIPE logging discipline (paper Table I)


@dataclasses.dataclass(frozen=True)
class PFarmConfig:
    num_buckets: int
    bucket_slots: int = 4
    window: int = 6                   # hopscotch neighbourhood H
    overflow_frac: float = 0.25       # overflow pool size as frac of buckets
    max_chain: int = 4                # chain hops followed per lookup

    @property
    def pool_blocks(self) -> int:
        return max(2, int(self.num_buckets * self.overflow_frac))

    @property
    def total_slots(self) -> int:
        return (self.num_buckets + self.pool_blocks) * self.bucket_slots

    @property
    def window_bytes(self) -> int:
        return self.window * (self.bucket_slots * SLOT_BYTES + 8)

    @property
    def block_bytes(self) -> int:
        return self.bucket_slots * SLOT_BYTES + 16  # slots + tok + next ptr

    def grow(self, factor: int = 2) -> "PFarmConfig":
        return dataclasses.replace(self, num_buckets=self.num_buckets * factor)


class PFarmTable(NamedTuple):
    """Table state; int32 words hold the reference's uint32 bits."""

    keys: torch.Tensor    # (N, bs, KL)
    vals: torch.Tensor    # (N, bs, VL)
    tok: torch.Tensor     # (N,) uint8
    head: torch.Tensor    # (N,) int32 — overflow chain head block (-1 none)
    okeys: torch.Tensor   # (PO, bs, KL) overflow pool
    ovals: torch.Tensor   # (PO, bs, VL)
    otok: torch.Tensor    # (PO,) uint8
    onext: torch.Tensor   # (PO,) int32
    ocount: torch.Tensor  # () int32 — allocated blocks
    count: torch.Tensor   # () int32


def create(cfg: PFarmConfig, device="cuda") -> PFarmTable:
    """Empty table on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    N, bs, PO = cfg.num_buckets, cfg.bucket_slots, cfg.pool_blocks

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return PFarmTable(
        keys=z(N, bs, KEY_LANES), vals=z(N, bs, VAL_LANES),
        tok=z(N, dtype=U8), head=torch.full((N,), -1, dtype=I32, device=dev),
        okeys=z(PO, bs, KEY_LANES), ovals=z(PO, bs, VAL_LANES),
        otok=z(PO, dtype=U8),
        onext=torch.full((PO,), -1, dtype=I32, device=dev),
        ocount=z(), count=z())


def load_factor(cfg: PFarmConfig, t: PFarmTable) -> torch.Tensor:
    return t.count.to(torch.float32) / cfg.total_slots


def _home(cfg, keys) -> torch.Tensor:
    return hash128(keys) % cfg.num_buckets


def _window_ids(cfg, home) -> torch.Tensor:
    return (home[:, None] + torch.arange(cfg.window, device=home.device)
            [None]) % cfg.num_buckets


class LookupResult(NamedTuple):
    found: torch.Tensor   # (B,) bool
    values: torch.Tensor  # (B, VAL_LANES) int32 words
    where: torch.Tensor   # (B, 3) int32 [in_chain, bucket_or_block, slot]
    reads: torch.Tensor   # (B,) int32 one window + chain hops followed


def lookup(cfg: PFarmConfig, t: PFarmTable, keys) -> LookupResult:
    keys = as_words(keys, KEY_LANES, t.keys.device)
    B, bs = keys.shape[0], cfg.bucket_slots
    rows = torch.arange(B, device=keys.device)
    home = _home(cfg, keys)
    win = _window_ids(cfg, home)                       # (B, H)
    bits = token_bits(t.tok[win], bs)
    match = (bits == 1) & (t.keys[win] == keys[:, None, None, :]).all(-1)
    mflat = match.reshape(B, -1)
    found = mflat.any(-1)
    first = _first(mflat)
    vals_out = torch.where(found[:, None],
                           t.vals[win].reshape(B, -1, VAL_LANES)[rows, first],
                           0)
    wbucket = win.gather(1, (first // bs)[:, None])[:, 0]
    where = torch.where(found[:, None], torch.stack(
        [torch.zeros_like(wbucket), wbucket, first % bs], -1), -1)

    # chain walk, at most max_chain hops: each is one more one-sided read
    cur = t.head[home].to(I64)
    hops = torch.zeros(B, dtype=I64, device=keys.device)
    for _ in range(cfg.max_chain):
        live = (cur >= 0) & ~found
        blk = cur.clamp(min=0)
        hops = hops + live.to(I64)
        bmatch = ((token_bits(t.otok[blk], bs) == 1)
                  & (t.okeys[blk] == keys[:, None, :]).all(-1) & live[:, None])
        bfound = bmatch.any(-1)
        bslot = _first(bmatch)
        vals_out = torch.where(bfound[:, None], t.ovals[blk, bslot], vals_out)
        where = torch.where(bfound[:, None], torch.stack(
            [torch.ones_like(blk), blk, bslot], -1), where)
        found = found | bfound
        cur = torch.where(live & ~bfound, t.onext[blk].to(I64), -1)
    return LookupResult(found, vals_out, where.to(I32), (1 + hops).to(I32))


def lookup_plan(cfg: PFarmConfig, t: PFarmTable, keys, res: LookupResult):
    """Verb plan of a lookup batch: one hopscotch-window READ plus chained
    dependent block READs (hop k at depth k)."""
    from repro_torch.rdma import verbs as rv
    keys = as_words(keys, KEY_LANES, t.keys.device)
    home = _home(cfg, keys)
    bucket_stride = cfg.bucket_slots * SLOT_BYTES + 8      # slots + token
    lanes = [(rv.READ, rv.REGION_TABLE, home * bucket_stride,
              cfg.window_bytes, 0, False)]
    cur = t.head[home].to(I64)
    for k in range(1, cfg.max_chain + 1):
        blk = cur.clamp(min=0)
        lanes.append((torch.where(k < res.reads, rv.READ, rv.NOOP),
                      rv.REGION_EXT, blk * cfg.block_bytes, cfg.block_bytes,
                      k, False))
        cur = t.onext[blk].to(I64)
    return rv.pack(keys.shape[0], lanes, keys.device)


def version_read_plan(cfg: PFarmConfig, t: PFarmTable, keys):
    """Stamp validation costs the full window-plus-chain lookup plan."""
    return lookup_plan(cfg, t, keys, lookup(cfg, t, keys))


def scan_plan(cfg: PFarmConfig, t: PFarmTable, keys, spans):
    """Verb plan of a YCSB-E short-scan batch: one whole-window READ per
    record, plus a chained block READ (depth 1) for each record past the
    window's capacity."""
    from repro_torch.rdma import verbs as rv
    keys = as_words(keys, KEY_LANES, t.keys.device)
    spans = np.maximum(np.asarray(spans, np.int32).reshape(-1), 1)
    act = torch.from_numpy(spans).to(keys.device)
    home = _home(cfg, keys)
    bucket_stride = cfg.bucket_slots * SLOT_BYTES + 8      # slots + token
    lanes = []
    for j in range(int(spans.max())):
        verb = torch.where(j < act, rv.READ, rv.NOOP)
        off = ((home + j * 5 + 1) % cfg.num_buckets) * bucket_stride
        lanes.append((verb, rv.REGION_TABLE, off, cfg.window_bytes, 0, False))
        if j + 1 > cfg.window:
            lanes.append((verb, rv.REGION_EXT,
                          (off // bucket_stride % max(1, cfg.pool_blocks))
                          * cfg.block_bytes, cfg.block_bytes, 1, False))
    return rv.pack(keys.shape[0], lanes, keys.device)


# -- server-side ops: the batch walked in order by the serial-walk kernel ----

def insert(cfg: PFarmConfig, t: PFarmTable, keys, vals, mask=None):
    """Window slot, else one displacement, else a chain block; 5 PM writes
    per op.  In place; returns ``(table, ok, ledger)``."""
    return walk("pfarm", "insert", cfg, t, keys, vals, mask)


def update(cfg: PFarmConfig, t: PFarmTable, keys, vals, mask=None):
    """Logged in-place value store: 5 PM writes."""
    return walk("pfarm", "update", cfg, t, keys, vals, mask)


def delete(cfg: PFarmConfig, t: PFarmTable, keys, mask=None):
    """Logged token-bit clear: 5 PM writes."""
    return walk("pfarm", "delete", cfg, t, keys, None, mask)
