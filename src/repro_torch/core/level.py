"""Level hashing baseline (Zuo, Hua, Wu — OSDI'18) in PyTorch.

Port of ``repro.core.level`` (the reference, unchanged).  A top level of N
buckets and a bottom level of N/2; a key's four candidate buckets are
top[h1], top[h2], bottom[h1/2], bottom[h2/2].  Each bucket has
``bucket_slots`` slots and a token byte (one valid bit per slot).  Remote
searches cost up to four scattered one-sided reads; PM writes per insert /
update / delete are 2 (5 on the one-movement path) / 2 (4 logged) / 1
(paper Table I).

Differences from the reference, by design:

  * **In place.** ``insert``/``update``/``delete`` mutate the table's
    tensors and return the SAME table object.
  * The reference's ``lax.scan`` over the batch (each op reads what the
    previous one left) is the serial-walk kernel
    (``kernels/scan_walk.py``): a CUDA kernel on a card, its per-op plain
    version on the CPU.  The batched read path is torch gathers.
  * Plan offsets are int64 (the reference's int32 ``(num_top + cand) *
    bucket_bytes`` wraps past 2**31 bytes).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.continuity import KEY_LANES, SLOT_BYTES, VAL_LANES, _first
from repro_torch.core.hashfn import hash128, hash128_2
from repro_torch.core.words import as_words, resolve_device
from repro_torch.kernels.scan_walk import walk

I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8


@dataclasses.dataclass(frozen=True)
class LevelConfig:
    num_top: int                 # top-level buckets (bottom = num_top // 2)
    bucket_slots: int = 4

    def __post_init__(self):
        if self.num_top % 2 or self.num_top < 2 or not \
                1 <= self.bucket_slots <= 8:
            raise ValueError(f"num_top must be even and bucket_slots in "
                             f"[1, 8]: {self.num_top}, {self.bucket_slots}")

    @property
    def num_bottom(self) -> int:
        return self.num_top // 2

    @property
    def total_slots(self) -> int:
        return (self.num_top + self.num_bottom) * self.bucket_slots

    @property
    def bucket_bytes(self) -> int:
        return self.bucket_slots * SLOT_BYTES + 8  # slots + token word

    def grow(self, factor: int = 2) -> "LevelConfig":
        return dataclasses.replace(self, num_top=self.num_top * factor)


class LevelTable(NamedTuple):
    """Table state; int32 words hold the reference's uint32 bits."""

    tkeys: torch.Tensor  # (NT, bs, KL)
    tvals: torch.Tensor  # (NT, bs, VL)
    ttok: torch.Tensor   # (NT,) uint8 — valid bits
    bkeys: torch.Tensor  # (NB, bs, KL)
    bvals: torch.Tensor  # (NB, bs, VL)
    btok: torch.Tensor   # (NB,) uint8
    count: torch.Tensor  # () int32


def create(cfg: LevelConfig, device="cuda") -> LevelTable:
    """Empty table on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    NT, NB, bs = cfg.num_top, cfg.num_bottom, cfg.bucket_slots

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return LevelTable(
        tkeys=z(NT, bs, KEY_LANES), tvals=z(NT, bs, VAL_LANES),
        ttok=z(NT, dtype=U8), bkeys=z(NB, bs, KEY_LANES),
        bvals=z(NB, bs, VAL_LANES), btok=z(NB, dtype=U8), count=z())


def load_factor(cfg: LevelConfig, t: LevelTable) -> torch.Tensor:
    return t.count.to(torch.float32) / cfg.total_slots


def _cand_buckets(cfg: LevelConfig, keys: torch.Tensor) -> torch.Tensor:
    """(B, 4) int64 candidate buckets [top h1, top h2, bottom h1/2,
    bottom h2/2]."""
    t1 = hash128(keys) % cfg.num_top
    t2 = hash128_2(keys) % cfg.num_top
    return torch.stack([t1, t2, t1 // 2, t2 // 2], -1)


def token_bits(tok: torch.Tensor, bucket_slots: int) -> torch.Tensor:
    """(..., bs) valid bits of uint8 tokens, as int64 0/1."""
    return (tok.to(I64)[..., None]
            >> torch.arange(bucket_slots, device=tok.device)) & 1


def _gather4(cfg, t: LevelTable, cand):
    """The four candidate buckets: (B,4,bs,·) keys/vals + (B,4,bs) valid."""
    keys4 = torch.cat([t.tkeys[cand[:, :2]], t.bkeys[cand[:, 2:]]], 1)
    vals4 = torch.cat([t.tvals[cand[:, :2]], t.bvals[cand[:, 2:]]], 1)
    tok4 = torch.cat([t.ttok[cand[:, :2]], t.btok[cand[:, 2:]]], 1)
    return keys4, vals4, token_bits(tok4, cfg.bucket_slots) == 1


class LookupResult(NamedTuple):
    found: torch.Tensor   # (B,) bool
    values: torch.Tensor  # (B, VAL_LANES) int32 words
    where: torch.Tensor   # (B, 2) int32 (bucket#0-3, slot) or -1
    reads: torch.Tensor   # (B,) int32 distinct buckets probed


def _distinct(cand: torch.Tensor) -> torch.Tensor:
    """(B, 4) bool: the probe order t1, t2, b1, b2 skips duplicates."""
    one = torch.ones(cand.shape[0], dtype=torch.bool, device=cand.device)
    return torch.stack([one, cand[:, 1] != cand[:, 0], one,
                        cand[:, 3] != cand[:, 2]], -1)


def lookup(cfg: LevelConfig, t: LevelTable, keys) -> LookupResult:
    keys = as_words(keys, KEY_LANES, t.tkeys.device)
    B, bs = keys.shape[0], cfg.bucket_slots
    cand = _cand_buckets(cfg, keys)
    k4, v4, valid = _gather4(cfg, t, cand)
    match = valid & (k4 == keys[:, None, None, :]).all(-1)     # (B,4,bs)
    mflat = match.reshape(B, -1)
    found = mflat.any(-1)
    first = _first(mflat)
    bidx, slot = first // bs, first % bs
    values = v4.reshape(B, -1, VAL_LANES)[torch.arange(B, device=keys.device),
                                          first]
    values = torch.where(found[:, None], values, 0)
    upto = torch.where(found, bidx, 3)
    mask = torch.arange(4, device=keys.device)[None, :] <= upto[:, None]
    reads = (_distinct(cand) & mask).sum(-1)
    where = torch.where(found[:, None], torch.stack([bidx, slot], -1), -1)
    return LookupResult(found, values, where.to(I32), reads.to(I32))


def lookup_plan(cfg: LevelConfig, t: LevelTable, keys, res: LookupResult):
    """Verb plan of a lookup batch: up to FOUR scattered one-sided bucket
    READs per key, probed in sequence (depth = probe rank; a negative
    search walks all four rounds)."""
    from repro_torch.rdma import verbs as rv
    keys = as_words(keys, KEY_LANES, t.tkeys.device)
    cand = _cand_buckets(cfg, keys)
    j = torch.arange(4, device=keys.device)[None, :]
    upto = torch.where(res.found, res.where[:, 0].to(I64), 3)
    act = _distinct(cand) & (j <= upto[:, None])
    rank = torch.cumsum(act.to(I32), 1) - act.to(I32)
    off = torch.where(j < 2, cand, cfg.num_top + cand) * cfg.bucket_bytes
    return rv.pack(keys.shape[0], [
        (torch.where(act[:, i], rv.READ, rv.NOOP), rv.REGION_TABLE,
         off[:, i], cfg.bucket_bytes, rank[:, i], False)
        for i in range(4)], keys.device)


def version_read_plan(cfg: LevelConfig, t: LevelTable, keys):
    """Stamp validation costs the full lookup plan (value-based stamps)."""
    return lookup_plan(cfg, t, keys, lookup(cfg, t, keys))


def scan_plan(cfg: LevelConfig, t: LevelTable, keys, spans):
    """Verb plan of a YCSB-E short-scan batch: one scattered bucket READ per
    record (depth 0), where continuity pays one verb per scan."""
    from repro_torch.rdma import verbs as rv
    keys = as_words(keys, KEY_LANES, t.tkeys.device)
    spans = np.maximum(np.asarray(spans, np.int32).reshape(-1), 1)
    home = hash128(keys) % cfg.num_top
    act = torch.from_numpy(spans).to(keys.device)
    return rv.pack(keys.shape[0], [
        (torch.where(j < act, rv.READ, rv.NOOP), rv.REGION_TABLE,
         ((home + j * 7 + 1) % cfg.num_top) * cfg.bucket_bytes,
         cfg.bucket_bytes, 0, False)
        for j in range(int(spans.max()))], keys.device)


# -- server-side ops: the batch walked in order by the serial-walk kernel ----

def insert(cfg: LevelConfig, t: LevelTable, keys, vals, mask=None):
    """Batched insert in batch order, in place: 2 PM writes per op, 5 on
    the one-movement path.  Returns ``(table, ok, ledger)``."""
    return walk("level", "insert", cfg, t, keys, vals, mask)


def update(cfg: LevelConfig, t: LevelTable, keys, vals, mask=None):
    """Out-of-place in the key's bucket (2 PM writes) or logged in place
    (4) when the bucket is full."""
    return walk("level", "update", cfg, t, keys, vals, mask)


def delete(cfg: LevelConfig, t: LevelTable, keys, mask=None):
    """Token-bit clear: 1 PM write."""
    return walk("level", "delete", cfg, t, keys, None, mask)
