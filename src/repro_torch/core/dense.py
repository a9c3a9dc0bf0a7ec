"""Dense block-table reference store (the vLLM-style baseline index) in
PyTorch.

Port of ``repro.core.dense`` (the reference, unchanged).  One flat, fully
associative region of ``capacity`` slots: a lookup fetches the whole table
(one contiguous fetch) and compares against every slot; an insert takes the
first free slot in index order.  PM writes: insert 2 (payload, live bit),
update 1, delete 1.

All ops are batched torch ops; ``_match`` is O(B*C) by design.  Tables
update in place.  Where two ops of one update batch match the same slot,
the last in batch order wins.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import pmem
from repro_torch.core.continuity import KEY_LANES, SLOT_BYTES, VAL_LANES, _first
from repro_torch.core.words import as_words, batch_words, resolve_device

I32 = torch.int32
I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class DenseConfig:
    capacity: int                 # total slots

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1: {self.capacity}")

    @property
    def total_slots(self) -> int:
        return self.capacity

    @property
    def table_bytes(self) -> int:
        return self.capacity * (SLOT_BYTES + 1)   # slots + live bytes

    def grow(self, factor: int = 2) -> "DenseConfig":
        return dataclasses.replace(self, capacity=self.capacity * factor)


class DenseTable(NamedTuple):
    keys: torch.Tensor    # (C, KL) int32 words
    vals: torch.Tensor    # (C, VL) int32 words
    live: torch.Tensor    # (C,) bool
    count: torch.Tensor   # () int32


def create(cfg: DenseConfig, device="cuda") -> DenseTable:
    """Empty table on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    C = cfg.capacity
    return DenseTable(
        keys=torch.zeros((C, KEY_LANES), dtype=I32, device=dev),
        vals=torch.zeros((C, VAL_LANES), dtype=I32, device=dev),
        live=torch.zeros((C,), dtype=torch.bool, device=dev),
        count=torch.zeros((), dtype=I32, device=dev))


def load_factor(cfg: DenseConfig, t: DenseTable) -> torch.Tensor:
    return t.count.to(torch.float32) / cfg.capacity


class LookupResult(NamedTuple):
    found: torch.Tensor   # (B,) bool
    values: torch.Tensor  # (B, VAL_LANES) int32 words
    slot: torch.Tensor    # (B,) int32 (-1 on miss)
    reads: torch.Tensor   # (B,) int32 — always 1 (whole-table fetch)


def _match(t: DenseTable, keys: torch.Tensor) -> torch.Tensor:
    """(B, C) bool: live slot holds exactly this key."""
    return t.live[None, :] & (t.keys[None, :, :] == keys[:, None, :]).all(-1)


def lookup(cfg: DenseConfig, t: DenseTable, keys) -> LookupResult:
    keys = as_words(keys, KEY_LANES, t.keys.device)
    m = _match(t, keys)
    found = m.any(-1)
    slot = torch.where(found, _first(m), -1)
    values = torch.where(found[:, None], t.vals[slot.clamp(min=0)], 0)
    return LookupResult(found, values, slot.to(I32),
                        torch.ones(keys.shape[0], dtype=I32,
                                   device=keys.device))


def _whole_table_plan(cfg: DenseConfig, t: DenseTable, keys):
    from repro_torch.rdma import verbs as rv
    keys = as_words(keys, KEY_LANES, t.keys.device)
    return rv.pack(keys.shape[0], [
        (rv.READ, rv.REGION_TABLE, 0, cfg.table_bytes, 0, False)],
        keys.device)


def lookup_plan(cfg: DenseConfig, t: DenseTable, keys, res: LookupResult):
    """One READ of the ENTIRE table region per key (the remote worst case)."""
    return _whole_table_plan(cfg, t, keys)


def version_read_plan(cfg: DenseConfig, t: DenseTable, keys):
    """Value-based stamps: a validation is a full (whole-table) lookup."""
    return lookup_plan(cfg, t, keys, lookup(cfg, t, keys))


def scan_plan(cfg: DenseConfig, t: DenseTable, keys, spans):
    """Dense storage is contiguous: one whole-table READ per scan."""
    return _whole_table_plan(cfg, t, keys)


def insert(cfg: DenseConfig, t: DenseTable, keys, vals, mask=None):
    """Batched insert: the active op of batch rank r takes the (r+1)-th free
    slot in index order (a cumsum over the free slots and a searchsorted).
    2 PM writes per op.  In place; returns ``(table, ok, ledger)``."""
    keys, vals, active = batch_words(t.keys.device, keys, vals, mask)
    free_upto = torch.cumsum((~t.live).to(I64), 0)     # free slots in [0, c]
    rank = torch.cumsum(active.to(I64), 0) - 1         # (B,) batch order
    ok = active & (rank < free_upto[-1])
    slot = torch.searchsorted(free_upto, rank + 1)[ok]
    t.keys[slot] = keys[ok]                             # phase 1: payload
    t.vals[slot] = vals[ok]
    t.live[slot] = True                                 # phase 2: commit
    n = ok.sum()
    t.count.add_(n.to(I32))
    ctr = pmem.CostLedger.zero(keys.device).add(pm_writes=2 * n,
                                                ops=active.sum())
    return t, ok, ctr


def _last_per_slot(slot: torch.Tensor, ok: torch.Tensor, C: int):
    """``ok`` cleared on every op that a later op of the batch overrides
    (same slot): the last write in batch order wins."""
    idx = torch.arange(slot.shape[0], device=slot.device)
    last = torch.full((C,), -1, dtype=I64, device=slot.device).scatter_reduce(
        0, slot[ok], idx[ok], "amax")
    return ok & (last[slot] == idx)


def update(cfg: DenseConfig, t: DenseTable, keys, vals, mask=None):
    """Batched in-place update: 1 PM write per op."""
    keys, vals, active = batch_words(t.keys.device, keys, vals, mask)
    m = _match(t, keys)
    ok = active & m.any(-1)
    slot = _first(m)
    win = _last_per_slot(slot, ok, cfg.capacity)
    t.vals[slot[win]] = vals[win]
    ctr = pmem.CostLedger.zero(keys.device).add(pm_writes=ok.sum(),
                                                ops=active.sum())
    return t, ok, ctr


def delete(cfg: DenseConfig, t: DenseTable, keys, mask=None):
    """Batched live-bit clear: 1 PM write per op.  Two ops of one batch on
    the same live key both succeed and both count, as in the reference."""
    keys, _, active = batch_words(t.keys.device, keys, None, mask)
    m = _match(t, keys)
    ok = active & m.any(-1)
    t.live[_first(m)[ok]] = False
    n = ok.sum()
    t.count.sub_(n.to(I32))
    ctr = pmem.CostLedger.zero(keys.device).add(pm_writes=n, ops=active.sum())
    return t, ok, ctr


def extract_items(cfg: DenseConfig, t: DenseTable):
    """Live (key, value) slots + validity mask."""
    return t.keys, t.vals, t.live
