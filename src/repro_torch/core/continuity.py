"""Continuity hashing (Liu, Hua, Bai — CS.DC 2021) in PyTorch: the request path.

Port of ``repro.core.continuity`` (the reference, unchanged), same layout::

      slot ids within one segment-pair row (SLOTS = 20):
      [ B_even: 0..3 | shared SBuckets: 4..15 | B_odd: 16..19 ]   + ext: 20..31

  * segment(even) = slots [0, 16), segment(odd) = slots [4, 20): the two
    segments of a pair overlap on the SBuckets, and one row is one
    contiguous region, so a segment fetch is ONE contiguous read;
  * a 32-bit ``indicator`` word per pair holds one valid bit per slot,
    committed with a single word store AFTER the slot payload (log-free
    failure atomicity); ``version`` is the word's upper half.

Storage: every uint32 field of the reference is an int32 tensor holding the
same bit pattern (see ``repro_torch.core.words``), so the table's bytes
equal the reference's field by field.

Differences from the reference, by design:

  * **In place.** ``insert``/``update``/``delete`` mutate the table's
    tensors and return the SAME table object (a functional copy of a
    full-size table is gigabytes per batch).  Take a ``convert.
    table_to_numpy`` snapshot first if the pre-state is needed.
  * ``lax.while_loop``/``cond`` become Python loops and branches on values
    read back from the device; the residual wave loops run on the subset
    of ops in the current wave only.
  * Scatters are masked index lists (``index_put_``/``index_add_``) in
    place of ``.at[...](mode="drop")``.  Set-scatters keep the reference's
    invariant that their indices are pairwise distinct.

The serial oracles (``insert_serial`` / ``update_serial`` /
``delete_serial``) replay the reference's ``lax.scan`` one op at a time in
batch order, as masked tensor writes that never wait for the device.
Resize (``resize``, ``resize_stepwise``, ``recover``) and the online split
(``split_begin`` / ``split_step`` / ``split_lookup``) move items with these
same ops: the grown table is new, the source table is drained in place.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import pmem
from repro_torch.core.hashfn import hash128, hash128_2
from repro_torch.core.words import (as_words, batch_words, bit, popcount,
                                    resolve_device, row_groups, to_i32, u32)

I32 = torch.int32
I64 = torch.int64

KEY_LANES = 4   # 16-byte keys (paper: 16 B)
VAL_LANES = 4   # 16-byte value slots (paper: values <= 15 B + metadata byte)
SLOT_BYTES = (KEY_LANES + VAL_LANES) * 4
INDICATOR_BYTES = 8  # stored/committed as one 8-byte atomic unit
FP_BYTES = 8         # fingerprint word, adjacent to the indicator (Dash-style)
FP_SLOT_BITS = 2     # fingerprint bits per main slot
FP_MASK = (1 << FP_SLOT_BITS) - 1
_FPW = 32 // FP_SLOT_BITS            # fp fields per 32-bit lane
STASH_CNT_SHIFT = 24                 # per-pair stash count byte (fp lane 1)
STASH_META_BYTES = 8                 # per-stash-entry meta word (atomic commit)
_STASH_ONE = 1 << STASH_CNT_SHIFT


@dataclasses.dataclass(frozen=True)
class ContinuityConfig:
    """Static geometry of a continuity hash table."""

    num_buckets: int                 # N numbered buckets (must be even)
    bucket_slots: int = 4            # slots per bucket (paper: 4)
    sbuckets: int = 3                # shared SBuckets per pair (paper: 3)
    ext_frac: float = 1.0 / 10.0     # max fraction of pairs with added SBuckets
    ext_groups: int = 1              # added SBucket groups per extended pair
    stash_frac: float = 0.0          # stash slots as a fraction of main slots

    def __post_init__(self):
        if self.num_buckets < 2 or self.num_buckets % 2:
            raise ValueError(f"num_buckets must be even and >= 2: "
                             f"{self.num_buckets}")
        if self.total_bits > 32:
            raise ValueError(
                f"indicator must fit one atomic word: {self.total_bits} bits")
        # fp lane 1 keeps its top byte for the per-pair stash count
        if self.slots_per_pair * FP_SLOT_BITS > 64 - 8:
            raise ValueError(
                f"fingerprint fields overflow the fp word: "
                f"{self.slots_per_pair}")

    # -- derived geometry ---------------------------------------------------
    @property
    def num_pairs(self) -> int:
        return self.num_buckets // 2

    @property
    def slots_per_pair(self) -> int:          # main row width
        return (2 + self.sbuckets) * self.bucket_slots

    @property
    def seg_slots(self) -> int:               # slots per segment
        return (1 + self.sbuckets) * self.bucket_slots

    @property
    def ext_slots(self) -> int:               # slots per extension group
        return self.sbuckets * self.bucket_slots * self.ext_groups

    @property
    def total_bits(self) -> int:
        return self.slots_per_pair + self.ext_slots

    @property
    def ext_pool_pairs(self) -> int:
        return max(1, int(np.ceil(self.num_pairs * self.ext_frac)))

    @property
    def n_cand(self) -> int:
        return self.seg_slots + self.ext_slots

    @property
    def segment_bytes(self) -> int:
        """Payload of one one-sided segment fetch (indicator + fingerprint
        word + segment slots)."""
        return INDICATOR_BYTES + FP_BYTES + self.seg_slots * SLOT_BYTES

    @property
    def row_bytes(self) -> int:
        """One full pair row: [B_even | indicator | fp | SBuckets | B_odd]."""
        return INDICATOR_BYTES + FP_BYTES + self.slots_per_pair * SLOT_BYTES

    @property
    def ext_bytes(self) -> int:
        return self.ext_slots * SLOT_BYTES

    @property
    def stash_slots(self) -> int:
        if self.stash_frac <= 0:
            return 0
        return max(1, int(np.ceil(
            self.num_pairs * self.slots_per_pair * self.stash_frac)))

    @property
    def stash_bytes(self) -> int:
        """The whole stash region (fetched as ONE contiguous READ)."""
        return self.stash_slots * (STASH_META_BYTES + SLOT_BYTES)

    def grow(self, factor: int = 2) -> "ContinuityConfig":
        return dataclasses.replace(self, num_buckets=self.num_buckets * factor)


@functools.lru_cache(maxsize=None)
def _probe_order(cfg: ContinuityConfig) -> np.ndarray:
    """(2, n_cand) int32: slot ids in probe-priority order per home parity."""
    bs, sp, seg = cfg.bucket_slots, cfg.slots_per_pair, cfg.seg_slots
    even = list(range(0, seg))                       # B_even then SBuckets, L->R
    odd = list(range(sp - 1, bs - 1, -1))            # B_odd then SBuckets, R->L
    ext = list(range(sp, sp + cfg.ext_slots))        # extension last, both
    return np.asarray([even + ext, odd + ext], dtype=np.int32)


class ContinuityTable(NamedTuple):
    """Table state; int32 tensors holding the reference's uint32 bits."""

    keys: torch.Tensor        # (P, SLOTS, KEY_LANES)
    vals: torch.Tensor        # (P, SLOTS, VAL_LANES)
    indicator: torch.Tensor   # (P,) one valid bit per slot (+ext bits)
    version: torch.Tensor     # (P,) per-pair committed-op counter
    ext_keys: torch.Tensor    # (PE, EXT_SLOTS, KEY_LANES)
    ext_vals: torch.Tensor    # (PE, EXT_SLOTS, VAL_LANES)
    ext_map: torch.Tensor     # (P,) pair -> ext group index, -1 = none
    ext_count: torch.Tensor   # () allocated extension groups
    count: torch.Tensor       # () live items
    fp: torch.Tensor          # (P, 2) 2-bit fp per main slot + stash count
    stash_keys: torch.Tensor  # (T, KEY_LANES) shared overflow stash
    stash_vals: torch.Tensor  # (T, VAL_LANES)
    stash_meta: torch.Tensor  # (T,) home pair + 1; 0 = free


def create(cfg: ContinuityConfig, device="cuda") -> ContinuityTable:
    """Empty table on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    P, S, E, PE = cfg.num_pairs, cfg.slots_per_pair, cfg.ext_slots, cfg.ext_pool_pairs
    T = max(cfg.stash_slots, 1)

    def z(*shape):
        return torch.zeros(shape, dtype=I32, device=dev)

    return ContinuityTable(
        keys=z(P, S, KEY_LANES), vals=z(P, S, VAL_LANES),
        indicator=z(P), version=z(P),
        ext_keys=z(PE, E, KEY_LANES), ext_vals=z(PE, E, VAL_LANES),
        ext_map=torch.full((P,), -1, dtype=I32, device=dev),
        ext_count=z(), count=z(), fp=z(P, 2),
        stash_keys=z(T, KEY_LANES), stash_vals=z(T, VAL_LANES),
        stash_meta=z(T))


def capacity(cfg: ContinuityConfig, table: ContinuityTable) -> torch.Tensor:
    """Total allocated storage units (paper's load-factor denominator)."""
    return (cfg.num_pairs * cfg.slots_per_pair + cfg.stash_slots
            + table.ext_count.to(I64) * cfg.ext_slots).to(torch.float32)


def load_factor(cfg: ContinuityConfig, table: ContinuityTable) -> torch.Tensor:
    return table.count.to(torch.float32) / capacity(cfg, table)


def locate(cfg: ContinuityConfig,
           keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (1): home bucket number -> (pair index, parity), int64."""
    bno = hash128(keys) % cfg.num_buckets
    return bno >> 1, bno & 1


def fingerprint(keys: torch.Tensor) -> torch.Tensor:
    """(B,) 2-bit slot fingerprint from the second hash function."""
    return hash128_2(keys.reshape(-1, KEY_LANES)) & FP_MASK


def stash_count(table: ContinuityTable, pair: torch.Tensor) -> torch.Tensor:
    """Per-pair stash occupancy byte (fp lane 1, top byte)."""
    return (u32(table.fp[pair, 1]) >> STASH_CNT_SHIFT) & 0xFF


def _keys_in(table: ContinuityTable, keys, lanes=KEY_LANES) -> torch.Tensor:
    return as_words(keys, lanes, table.keys.device)


def _fp_store(table: ContinuityTable, ok, pair, slot, fpv) -> None:
    """Set the fp field of (pair, slot) for the ``ok`` lanes — main slots
    only, pairwise-distinct pairs (one op per pair per wave)."""
    pair, slot, fpv = pair[ok], slot[ok], fpv[ok]
    w = slot // _FPW
    sh = FP_SLOT_BITS * (slot % _FPW)
    old = u32(table.fp[pair, w])
    new = (old & ~(FP_MASK << sh)) | ((fpv & FP_MASK) << sh)
    table.fp[pair, w] = to_i32(new)


def _scatter_payload(table: ContinuityTable, ok, pair, slot_id, ext_idx,
                     key, val, slots_per_pair) -> None:
    """Phase 1: payload store of the ``ok`` lanes (distinct slots)."""
    S = slots_per_pair
    is_ext = slot_id >= S
    m = ok & ~is_ext
    table.keys[pair[m], slot_id[m]] = key[m]
    table.vals[pair[m], slot_id[m]] = val[m]
    e = ok & is_ext
    table.ext_keys[ext_idx[e], slot_id[e] - S] = key[e]
    table.ext_vals[ext_idx[e], slot_id[e] - S] = val[e]


def _commit_indicator(table: ContinuityTable, ok, pair, new_word) -> None:
    """Phase 2: ONE word store per op commits it; the version counter is
    the same 8-byte word's upper half (zero extra PM writes)."""
    p = pair[ok]
    table.indicator[p] = to_i32(new_word[ok])
    table.version.index_add_(0, p, torch.ones_like(p, dtype=I32))


# ---------------------------------------------------------------------------
# candidate gathering — the "one contiguous segment fetch" primitive
# ---------------------------------------------------------------------------

def _gather_candidates(cfg: ContinuityConfig, table: ContinuityTable,
                       pair: torch.Tensor, parity: torch.Tensor,
                       ext_allowed: torch.Tensor):
    """Fetch each key's candidate slots in probe order.

    Returns (cand_ids, cand_keys, cand_vals, valid, slot_ok, is_ext, has_ext),
    as the reference does."""
    cand, cand_keys, valid, slot_ok, is_ext, has_ext, eidx = \
        _candidate_keys(cfg, table, pair, parity, ext_allowed)
    S = cfg.slots_per_pair
    mvals = table.vals[pair[:, None], cand.clamp(max=S - 1)]
    evals = table.ext_vals[eidx.clamp(min=0)[:, None], (cand - S).clamp(min=0)]
    cand_vals = torch.where(is_ext[..., None], evals, mvals)
    return cand, cand_keys, cand_vals, valid, slot_ok, is_ext, has_ext


@functools.lru_cache(maxsize=64)
def _probe_tensor(cfg: ContinuityConfig, device: torch.device) -> torch.Tensor:
    """`_probe_order` as an int64 tensor on ``device`` (made once: a copy
    to the card per call would wait for the device)."""
    return torch.as_tensor(_probe_order(cfg), device=device).to(I64)


def _candidate_keys(cfg, table, pair, parity, ext_allowed):
    cand = _probe_tensor(cfg, pair.device)[parity]     # (B, C)
    S = cfg.slots_per_pair
    is_ext = cand >= S
    bits = (u32(table.indicator[pair])[:, None] >> cand) & 1
    mkeys = table.keys[pair[:, None], cand.clamp(max=S - 1)]
    eidx = table.ext_map[pair].to(I64)
    has_ext = eidx >= 0
    ekeys = table.ext_keys[eidx.clamp(min=0)[:, None], (cand - S).clamp(min=0)]
    cand_keys = torch.where(is_ext[..., None], ekeys, mkeys)
    slot_ok = torch.where(is_ext, (has_ext | ext_allowed)[:, None], True)
    valid = (bits == 1) & slot_ok & torch.where(is_ext, has_ext[:, None], True)
    return cand, cand_keys, valid, slot_ok, is_ext, has_ext, eidx


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.int8), dim=-1)


def _take(cand: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    return cand.gather(1, first[:, None])[:, 0]


# ---------------------------------------------------------------------------
# client read path — single one-sided fetch (paper §III-B)
# ---------------------------------------------------------------------------

class LookupResult(NamedTuple):
    found: torch.Tensor   # (B,) bool
    values: torch.Tensor  # (B, VAL_LANES) int32 words
    slot: torch.Tensor    # (B,) int32 — matched slot id (or -1); stash hits
    #   report cfg.total_bits + stash_index
    pair: torch.Tensor    # (B,) int32
    reads: torch.Tensor   # (B,) int32 — contiguous fetches this lookup needed


def _stash_tail(cfg, table, keys, pair, found, values, slot, reads):
    """Stash probe of a lookup: the whole region arrives in one contiguous
    READ; priority main > extension > stash.  Each query compares only the
    entries homed at its pair (`_stash_find`)."""
    found_me = found
    shit, sfirst = _stash_find(cfg, table, keys, pair)
    sfound = shit & ~found
    values = torch.where(sfound[:, None], table.stash_vals[sfirst], values)
    slot = torch.where(sfound, cfg.total_bits + sfirst, slot)
    reads = reads + ((stash_count(table, pair) > 0) & ~found_me).to(I64)
    return found | sfound, values, slot, reads


# (query, stash entry) lanes one chunk of `_stash_find` compares at most
_STASH_FIND_LANES = 1 << 24
# spare count bins of `_stash_find` for free stash rows: their adds spread
# over these instead of queueing on one address
_SPARE_BINS = 1024


def _stash_find(cfg, table: ContinuityTable, keys, pair):
    """``(hit, sidx)`` per query: whether a live stash entry homed at the
    query's pair (``stash_meta == pair + 1``) holds its key, and the
    lowest such stash index (0 where none; callers mask it).

    A stash index keyed by home pair, built per call: the live entries
    are counted per home (one T-wide scatter-add), ordered by home with a
    stable sort (index order kept within a home), each query's range is
    found by ``searchsorted``, and only that range is compared.  Memory
    is O(B * c + T + P), c the longest range a query has.  The one host
    sync reads the live count and c together; a stash with no entry at
    any queried pair stops there, after a few T-wide passes.
    `_stash_find_dense` is the plain (B, T) version it equals."""
    B, dev = keys.shape[0], keys.device
    hit = torch.zeros(B, dtype=torch.bool, device=dev)
    sidx = torch.zeros(B, dtype=I64, device=dev)
    if not B:
        return hit, sidx
    meta = table.stash_meta.to(I64)
    T = meta.shape[0]
    live = meta != 0
    ids = torch.arange(T, device=dev)
    bins = torch.where(live, meta,
                       cfg.num_pairs + 1 + (ids & (_SPARE_BINS - 1)))
    counts = torch.zeros(cfg.num_pairs + 1 + _SPARE_BINS, dtype=I32,
                         device=dev).index_add_(
        0, bins, torch.ones(T, dtype=I32, device=dev))
    home = pair.to(I64) + 1
    cnt = counts[home]
    n_live, c = torch.stack([live.sum(), cnt.max().to(I64)]).tolist()
    if not c:
        return hit, sidx
    # the live rows in index order (the free ones land past the end)
    at = torch.where(live, torch.cumsum(live, 0) - 1, n_live)
    rows = torch.empty(n_live + 1, dtype=I64, device=dev).scatter_(
        0, at, ids)[:n_live]
    homes, by_home = torch.sort(meta[rows], stable=True)
    rows = rows[by_home]
    lo = torch.searchsorted(homes, home)
    j = torch.arange(c, device=dev)
    step = max(1, _STASH_FIND_LANES // c)
    for s in range(0, B, step):
        q = slice(s, s + step)
        ent = rows[(lo[q, None] + j).clamp(max=n_live - 1)]
        m = (j < cnt[q, None]) & (
            table.stash_keys[ent] == keys[q, None, :]).all(-1)
        hit[q] = m.any(-1)
        sidx[q] = torch.where(hit[q], _take(ent, _first(m)), 0)
    return hit, sidx


def _stash_find_dense(cfg, table: ContinuityTable, keys, pair):
    """The plain version of `_stash_find`: a dense (B, T) compare of every
    query against every stash entry (tests only)."""
    home = pair.to(I32) + 1
    smatch = (table.stash_meta[None, :] == home[:, None]) & (
        table.stash_keys[None, :, :] == keys[:, None, :]).all(-1)
    return smatch.any(-1), _first(smatch)


def lookup(cfg: ContinuityConfig, table: ContinuityTable,
           keys) -> LookupResult:
    """Batched client read: ONE contiguous segment fetch per key (+1 iff the
    pair has added SBuckets and the main segment missed, +1 iff the pair's
    stash count byte is non-zero and both main and extension missed)."""
    keys = _keys_in(table, keys)
    pair, parity = locate(cfg, keys)
    return _lookup_at(cfg, table, keys, pair, parity)


def _lookup_at(cfg, table, keys, pair, parity) -> LookupResult:
    """`lookup` of word keys whose home ``(pair, parity)`` is known."""
    f = torch.zeros(keys.shape[0], dtype=torch.bool, device=keys.device)
    cand, ckeys, cvals, valid, _, is_ext, has_ext = _gather_candidates(
        cfg, table, pair, parity, ext_allowed=f)
    match = valid & (ckeys == keys[:, None, :]).all(-1)
    found = match.any(-1)
    first = _first(match)
    slot = torch.where(found, _take(cand, first), -1)
    values = cvals[torch.arange(keys.shape[0], device=keys.device), first]
    values = torch.where(found[:, None], values, 0)
    found_main = (match & ~is_ext).any(-1)
    reads = 1 + (has_ext & ~found_main).to(I64)
    if cfg.stash_slots:
        found, values, slot, reads = _stash_tail(
            cfg, table, keys, pair, found, values, slot, reads)
    return LookupResult(found, values, slot.to(I32), pair.to(I32),
                        reads.to(I32))


def lookup_plan(cfg: ContinuityConfig, table: ContinuityTable, keys,
                res: LookupResult):
    """Verb plan of a lookup batch (paper §III-B): ONE contiguous segment
    READ per key, plus one DEPENDENT extension-group READ iff the pair has
    added SBuckets and the main segment missed, and one dependent
    stash-region READ iff the pair's stash count byte is non-zero and both
    prior fetches missed.  The lookup's `CostLedger` is derived from it."""
    from repro_torch.rdma import verbs as rv
    keys = _keys_in(table, keys)
    pair, parity = locate(cfg, keys)
    seg_off = pair * cfg.row_bytes + parity * (cfg.bucket_slots * SLOT_BYTES)
    slot = res.slot.to(I64)
    found_main = res.found & (slot >= 0) & (slot < cfg.slots_per_pair)
    emap = table.ext_map[pair].to(I64)
    ext = (emap >= 0) & ~found_main
    lanes = [
        (rv.READ, rv.REGION_TABLE, seg_off, cfg.segment_bytes, 0, False),
        (torch.where(ext, rv.READ, rv.NOOP), rv.REGION_EXT,
         emap.clamp(min=0) * cfg.ext_bytes, cfg.ext_bytes, 1, False),
    ]
    if cfg.stash_slots:
        found_me = res.found & (slot >= 0) & (slot < cfg.total_bits)
        srd = (stash_count(table, pair) > 0) & ~found_me
        lanes.append((torch.where(srd, rv.READ, rv.NOOP), rv.REGION_STASH,
                      0, cfg.stash_bytes, torch.where(ext, 2, 1), False))
    return rv.pack(keys.shape[0], lanes, keys.device)


def scan_plan(cfg: ContinuityConfig, table: ContinuityTable, keys, spans):
    """Verb plan of a YCSB-E short-scan batch: ONE contiguous multi-segment
    READ per scan, whatever the span — ``ceil(span / slots_per_pair)``
    consecutive rows from the start key's pair (clamped to the table's
    tail), where the scattered baselines pay one READ per record."""
    from repro_torch.rdma import verbs as rv
    keys = _keys_in(table, keys)
    spans = torch.from_numpy(np.maximum(
        np.asarray(spans, np.int32).reshape(-1), 1)).to(keys.device, I64)
    pair, _ = locate(cfg, keys)
    rows = -(-spans // cfg.slots_per_pair)          # ceil: rows crossed
    start = torch.minimum(pair, (cfg.num_pairs - rows).clamp(min=0))
    return rv.pack(keys.shape[0], [
        (rv.READ, rv.REGION_TABLE, start * cfg.row_bytes,
         rows * cfg.row_bytes, 0, False)], keys.device)


def version_stamp(cfg: ContinuityConfig, table: ContinuityTable, keys):
    """(B, 2) version stamp per key: ``[version, indicator]`` of the key's
    home pair — the two halves of the ONE 8-byte word every committed
    mutation atomically stores (ABA-proof through the counter half)."""
    keys = _keys_in(table, keys)
    pair, _ = locate(cfg, keys)
    return torch.stack([table.version[pair], table.indicator[pair]], dim=-1)


def version_read_plan(cfg: ContinuityConfig, table: ContinuityTable, keys):
    """Verb plan of a stamp validation batch: ONE depth-0 8-byte READ per
    key at the home pair's indicator-word offset."""
    from repro_torch.rdma import verbs as rv
    keys = _keys_in(table, keys)
    pair, _ = locate(cfg, keys)
    return rv.single_read_plan(keys.shape[0], rv.REGION_TABLE,
                               pair * cfg.row_bytes, INDICATOR_BYTES,
                               keys.device)


# ---------------------------------------------------------------------------
# serial oracles — the reference's ``lax.scan`` ops, one op at a time
# ---------------------------------------------------------------------------
# Each op runs on (1,)-shaped tensors; a store the reference drops with an
# out-of-range index (``mode="drop"``) is a masked read-modify-write here,
# so the loop enqueues its work without waiting for the device.  Phase 1
# writes the slot payload, phase 2 commits it with ONE indicator-word store.

def _put(dst: torch.Tensor, idx, cond: torch.Tensor, value) -> None:
    """``dst[idx] = value`` where ``cond``, else unchanged."""
    old = dst[idx]
    c = cond.reshape(cond.shape + (1,) * (old.dim() - cond.dim()))
    if isinstance(value, torch.Tensor):
        value = value.to(dst.dtype)
    dst[idx] = torch.where(c, value, old)


def _bump(dst: torch.Tensor, idx, cond: torch.Tensor, amount: int) -> None:
    """``dst[idx] += amount`` where ``cond`` (int32 words wrap)."""
    dst.index_add_(0, idx, torch.where(cond, amount, 0).to(dst.dtype))


def _commit_one(table: ContinuityTable, ok, pair, word) -> None:
    """Phase 2 of one op: the indicator word and its version half."""
    _put(table.indicator, pair, ok, to_i32(word))
    _bump(table.version, pair, ok, 1)


def _fp_store_one(cfg, table: ContinuityTable, ok, pair, slot, fpv) -> None:
    """Set the fp field of main slot (pair, slot) where ``ok``."""
    w = slot.clamp(max=cfg.slots_per_pair - 1) // _FPW
    sh = FP_SLOT_BITS * (slot % _FPW)
    old = u32(table.fp[pair, w])
    new = (old & ~(FP_MASK << sh)) | ((fpv & FP_MASK) << sh)
    _put(table.fp, (pair, w), ok, to_i32(new))


def _payload_one(cfg, table: ContinuityTable, ok, pair, slot, ext_idx, key,
                 val) -> None:
    """Phase 1 of one op: the slot's key and value (main row or its
    extension group)."""
    S = cfg.slots_per_pair
    is_ext = slot >= S
    main = (pair, slot.clamp(max=S - 1))
    _put(table.keys, main, ok & ~is_ext, key)
    _put(table.vals, main, ok & ~is_ext, val)
    ext = (ext_idx, (slot - S).clamp(min=0))
    _put(table.ext_keys, ext, ok & is_ext, key)
    _put(table.ext_vals, ext, ok & is_ext, val)


def _stash_index(cfg, table: ContinuityTable, slot) -> torch.Tensor:
    """Stash row of a lookup's stash hit (``slot - total_bits``), clamped
    into the region for the lanes that are not one."""
    return (slot - cfg.total_bits).clamp(0, table.stash_meta.shape[0] - 1)


def _home_of(cfg: ContinuityConfig, keys):
    """``(pair, parity, fingerprint)`` of word keys: what the one-op
    functions take, computed once per batch by `_scan_op`."""
    pair, parity = locate(cfg, keys)
    return pair, parity, fingerprint(keys)


def _find_insert_slot(cfg: ContinuityConfig, table: ContinuityTable, key,
                      home):
    """First empty candidate slot of ``key`` (paper's directional scan),
    extension slots allowed if allocated or allocatable.  Returns
    ``(pair, slot, ok, need_alloc, ext_idx)``, each of shape (1,)."""
    pair, parity, _ = home
    if cfg.ext_frac > 0:
        can_alloc = (table.ext_count < cfg.ext_pool_pairs).reshape(1)
    else:
        can_alloc = torch.zeros(1, dtype=torch.bool, device=key.device)
    cand, _, valid, slot_ok, _, has_ext, eidx = _candidate_keys(
        cfg, table, pair, parity, can_alloc)
    empty = ~valid & slot_ok
    ok = empty.any(-1)
    slot = _take(cand, _first(empty))
    need_alloc = ok & (slot >= cfg.slots_per_pair) & ~has_ext
    ext_idx = torch.where(need_alloc, table.ext_count.to(I64),
                          eidx.clamp(min=0))
    return pair, slot, ok, need_alloc, ext_idx


def _stash_insert_one(cfg, table: ContinuityTable, key, val, want, pair):
    """Stash fallback of one insert (``want``: probe failed, op active).

    Record order for crash atomicity: fp count bump (uncounted metadata,
    may overcount) -> payload -> version bump -> meta word commit.  The 8 B
    meta word is the atomic commit point.  3 counted PM writes."""
    free = table.stash_meta == 0
    sok = want & free.any()
    sidx = _first(free).reshape(1)
    fp1 = table.fp.view(-1)
    _bump(fp1, pair * 2 + 1, sok, _STASH_ONE)
    _put(table.stash_keys, sidx, sok, key)
    _put(table.stash_vals, sidx, sok, val)
    _bump(table.version, pair, sok, 1)
    _put(table.stash_meta, sidx, sok, to_i32(pair + 1))
    table.count.add_(sok.sum().to(I32))
    return table, sok


def _insert_one(cfg, table: ContinuityTable, key, val, active, home=None):
    """One insert: ``(table, ok, pm)``, the table updated in place.
    ``home``: the key's `_home_of`, computed here when not given."""
    home = _home_of(cfg, key) if home is None else home
    pair, slot, ok, need_alloc, ext_idx = _find_insert_slot(cfg, table, key,
                                                            home)
    ok = ok & active
    need_alloc = need_alloc & active
    # extension allocation is metadata (rebuilt on recovery from ext_map)
    _put(table.ext_map, pair, need_alloc, ext_idx.to(I32))
    table.ext_count.add_(need_alloc.sum().to(I32))
    _payload_one(cfg, table, ok, pair, slot, ext_idx, key, val)
    # the NEW slot's fingerprint field lands before the commit (main only)
    _fp_store_one(cfg, table, ok & (slot < cfg.slots_per_pair), pair, slot,
                  home[2])
    word = u32(table.indicator[pair]) | torch.where(ok, bit(slot), 0)
    _commit_one(table, ok, pair, word)
    table.count.add_(ok.sum().to(I32))
    pm = torch.where(ok, 2, 0)
    if cfg.stash_slots:
        table, sok = _stash_insert_one(cfg, table, key, val, active & ~ok,
                                       pair)
        ok = ok | sok
        pm = pm + torch.where(sok, 3, 0)
    return table, ok, pm


def _delete_one(cfg, table: ContinuityTable, key, active, home=None):
    """One delete: ``(table, ok, pm)``, the table updated in place."""
    home = _home_of(cfg, key) if home is None else home
    res = _lookup_at(cfg, table, key, home[0], home[1])
    ok = res.found & active
    pair, slot = res.pair.to(I64), res.slot.to(I64)
    in_stash = ok & (slot >= cfg.total_bits)
    okm = ok & ~in_stash
    safe = slot.clamp(0, cfg.total_bits - 1)
    word = u32(table.indicator[pair]) & ~torch.where(okm, bit(safe), 0)
    _commit_one(table, okm, pair, word)
    pm = torch.where(okm, 1, 0)
    if cfg.stash_slots:
        # stash delete: version bump -> meta clear (the atomic commit) ->
        # fp count decrement (uncounted, AFTER the commit so the count byte
        # never reads LOW of the true occupancy at any crash prefix)
        sidx = _stash_index(cfg, table, slot)
        _bump(table.version, pair, in_stash, 1)
        _put(table.stash_meta, sidx, in_stash, 0)
        _bump(table.fp.view(-1), pair * 2 + 1, in_stash, -_STASH_ONE)
        pm = pm + torch.where(in_stash, 2, 0)
    table.count.sub_(ok.sum().to(I32))
    return table, ok, pm


def _update_one(cfg, table: ContinuityTable, key, val, active, home=None):
    """Out-of-place update: both bit flips land in ONE indicator store.

    A key living in the stash relocates into an empty main/SBucket slot
    (payload -> fp -> indicator commit makes the new copy win by probe
    priority -> stash meta clear); with no empty candidate the update
    fails rather than tearing the stash entry in place."""
    home = _home_of(cfg, key) if home is None else home
    res = _lookup_at(cfg, table, key, home[0], home[1])
    found = res.found & active
    pair, old_slot = res.pair.to(I64), res.slot.to(I64)
    parity = home[1]
    no = torch.zeros(1, dtype=torch.bool, device=key.device)
    cand, _, valid, slot_ok, _, _, _ = _candidate_keys(cfg, table, pair,
                                                       parity, no)
    empty = ~valid & slot_ok
    has_empty = empty.any(-1)
    new_slot = _take(cand, _first(empty))
    in_stash = found & (old_slot >= cfg.total_bits)
    ok = found & has_empty
    okm = ok & ~in_stash
    oks = ok & in_stash
    ext_idx = table.ext_map[pair].to(I64).clamp(min=0)
    _payload_one(cfg, table, ok, pair, new_slot, ext_idx, key, val)
    _fp_store_one(cfg, table, ok & (new_slot < cfg.slots_per_pair), pair,
                  new_slot, home[2])
    safe_old = old_slot.clamp(0, cfg.total_bits - 1)
    flip = torch.where(okm, bit(safe_old), 0) | bit(new_slot)
    word = u32(table.indicator[pair]) ^ torch.where(ok, flip, 0)
    _commit_one(table, ok, pair, word)
    pm = torch.where(okm, 2, 0)
    if cfg.stash_slots:
        sidx = _stash_index(cfg, table, old_slot)
        _put(table.stash_meta, sidx, oks, 0)
        _bump(table.fp.view(-1), pair * 2 + 1, oks, -_STASH_ONE)
        pm = pm + torch.where(oks, 3, 0)
    return table, ok, pm


def _scan_op(cfg, one_fn, table, keys, vals, active):
    """Run ``one_fn`` over the batch in batch order; masked-off ops count
    neither writes nor the ops denominator.  ``(table, ok, ledger)``."""
    B = keys.shape[0]
    dev = keys.device
    ok = torch.zeros(B, dtype=torch.bool, device=dev)
    pm = torch.zeros((), dtype=I64, device=dev)
    home = _home_of(cfg, keys)
    for i in range(B):
        op = slice(i, i + 1)
        args = (keys[op],) if vals is None else (keys[op], vals[op])
        table, okw, pmw = one_fn(cfg, table, *args, active[op],
                                 tuple(h[op] for h in home))
        ok[op] = okw
        pm += pmw.sum()
    ctr = pmem.CostLedger.zero(dev).add(pm_writes=pm, ops=active.sum())
    return table, ok, ctr


def insert_serial(cfg: ContinuityConfig, table: ContinuityTable, keys, vals,
                  mask=None):
    """The reference's serial insert (batch-order deterministic), in
    place. 2 PM writes/op (3 on the stash-fallback path); the equivalence
    oracle of the wave engine.  Returns ``(table, ok, ledger)``."""
    keys, vals, active = batch_words(table.keys.device, keys, vals, mask)
    return _scan_op(cfg, _insert_one, table, keys, vals, active)


def delete_serial(cfg: ContinuityConfig, table: ContinuityTable, keys,
                  mask=None):
    """The reference's serial delete, in place. 1 PM write/op (indicator
    bit clear; 2 for stash entries: version bump + meta clear)."""
    keys, _, active = batch_words(table.keys.device, keys, mask=mask)
    return _scan_op(cfg, _delete_one, table, keys, None, active)


def update_serial(cfg: ContinuityConfig, table: ContinuityTable, keys, vals,
                  mask=None):
    """The reference's serial out-of-place update, in place. 2 PM
    writes/op (3 when the op relocates a stash entry into the main row)."""
    keys, vals, active = batch_words(table.keys.device, keys, vals, mask)
    return _scan_op(cfg, _update_one, table, keys, vals, active)


# ---------------------------------------------------------------------------
# wave-vectorized mutation engine
# ---------------------------------------------------------------------------
# One stable sort by pair groups a batch into per-pair cohorts (batch order
# inside each); ops of equal intra-cohort rank ("waves") touch pairwise-
# distinct pairs.  Insert runs all waves fused in one rank-indexed
# bit-select pass (occupancy only grows); update/delete resolve every
# match from the pre-batch table in one pass.  Parity-contended insert
# cohorts and duplicate-target update/delete ops run the exact residual
# wave loop.  See the reference module for the full argument.

def _stable_order(cls: torch.Tensor):
    """Stable ascending order of small int class ids: ``(cls_s, idx_s)``
    (the reference packs (class, position) into one uint32 sort key; a
    stable sort gives the same order)."""
    return torch.sort(cls.to(I64), stable=True)


def _cohort_ranks(cls_s: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its (sorted, contiguous) class run."""
    B = cls_s.shape[0]
    ii = torch.arange(B, dtype=I64, device=cls_s.device)
    head = torch.ones(B, dtype=torch.bool, device=cls_s.device)
    head[1:] = cls_s[1:] != cls_s[:-1]
    return ii - torch.cummax(torch.where(head, ii, 0), dim=0).values


def _plan_waves(cfg: ContinuityConfig, keys: torch.Tensor,
                active: torch.Tensor):
    """``(pair, parity, rank, num_waves)``: ``rank[i]`` is op i's position
    among active same-pair ops in batch order (-1 if inactive)."""
    B = keys.shape[0]
    pair, parity = locate(cfg, keys)
    cls = torch.where(active, pair, cfg.num_pairs)
    cls_s, order = _stable_order(cls)
    rank = torch.empty(B, dtype=I64, device=keys.device)
    rank[order] = _cohort_ranks(cls_s)
    rank = torch.where(active, rank, -1)
    num_waves = int(rank.max()) + 1 if B else 0
    return pair, parity, rank, num_waves


def _bitreverse32(v: torch.Tensor) -> torch.Tensor:
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return ((v >> 16) | (v << 16)) & 0xFFFFFFFF


def _canonical_occupancy(cfg: ContinuityConfig, ind: torch.Tensor,
                         parity: torch.Tensor) -> torch.Tensor:
    """Rearrange indicator word values so bit p = the op's p-th probe
    candidate (odd homes: one bit reversal); ext bits follow at seg.."""
    S, seg, E = cfg.slots_per_pair, cfg.seg_slots, cfg.ext_slots
    main = torch.where(parity == 0, ind, _bitreverse32(ind) >> (32 - S))
    canon = main & ((1 << seg) - 1)
    if E:
        canon = canon | (((ind >> S) & ((1 << E) - 1)) << seg)
    return canon


def _select_bit(word: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Position of the (n+1)-th set bit of each word value (branch-free
    5-step binary descend on popcounts; valid iff n < popcount(word))."""
    pos = torch.zeros_like(word)
    rem = n.to(I64)
    for width in (16, 8, 4, 2, 1):
        cnt = popcount((word >> pos) & ((1 << width) - 1))
        go = rem >= cnt
        rem = torch.where(go, rem - cnt, rem)
        pos = torch.where(go, pos + width, pos)
    return pos


def _slot_of(cfg, pos, parity):
    S, seg = cfg.slots_per_pair, cfg.seg_slots
    return torch.where(pos < seg, torch.where(parity == 0, pos, S - 1 - pos),
                       S + (pos - seg))


def _insert_wave_plan(cfg: ContinuityConfig, table: ContinuityTable,
                      pair, parity, m):
    """Probe phase of one insert wave over its active ops (``m`` all true
    here): pick each op's slot and grant extension groups by prefix sum
    over batch order.  Returns ``(slot, ok, grant, ext_idx)``."""
    B = pair.shape[0]
    if cfg.ext_frac > 0:
        pool_left = cfg.ext_pool_pairs - int(table.ext_count)
    else:
        pool_left = 0
    opt = torch.full((B,), pool_left > 0, dtype=torch.bool, device=pair.device)
    cand, _, valid, slot_ok, is_ext, has_ext, eidx = _candidate_keys(
        cfg, table, pair, parity, ext_allowed=opt)
    empty = (~valid) & slot_ok
    slot = _take(cand, _first(empty))
    want = m & empty.any(-1) & (slot >= cfg.slots_per_pair) & ~has_ext
    grant = want & (torch.cumsum(want.to(I64), 0) - 1 < pool_left)
    denied = want & ~grant
    empty = torch.where(denied[:, None], empty & ~is_ext, empty)
    ok = m & empty.any(-1)
    slot = _take(cand, _first(empty))
    new_idx = int(table.ext_count) + torch.cumsum(grant.to(I64), 0) - 1
    ext_idx = torch.where(grant, new_idx, eidx.clamp(min=0))
    return slot, ok, grant, ext_idx


def _insert_wave(cfg: ContinuityConfig, table: ContinuityTable, keys, vals,
                 pair, parity, m):
    """Execute one insert wave (active ops have distinct pairs), in place.
    Returns ``(table, ok, grant, ext_idx)`` over the full batch."""
    B = keys.shape[0]
    idx = m.nonzero().squeeze(1)
    k, v, p, par = keys[idx], vals[idx], pair[idx], parity[idx]
    ones = torch.ones(idx.shape[0], dtype=torch.bool, device=keys.device)
    slot, okw, gw, eix = _insert_wave_plan(cfg, table, p, par, ones)
    table.ext_map[p[gw]] = eix[gw].to(I32)
    table.ext_count.add_(gw.sum().to(I32))
    _scatter_payload(table, okw, p, slot, eix, k, v, cfg.slots_per_pair)
    _fp_store(table, okw & (slot < cfg.slots_per_pair), p, slot,
              fingerprint(k))
    word = u32(table.indicator[p]) | torch.where(okw, bit(slot), 0)
    _commit_indicator(table, okw, p, word)
    table.count.add_(okw.sum().to(I32))
    ok = torch.zeros(B, dtype=torch.bool, device=keys.device)
    grant = torch.zeros_like(ok)
    ext_idx = torch.zeros(B, dtype=I64, device=keys.device)
    ok[idx], grant[idx], ext_idx[idx] = okw, gw, eix
    return table, ok, grant, ext_idx


def _reorder_ext_pool(cfg: ContinuityConfig, table: ContinuityTable,
                      alloc_pos, alloc_idx) -> None:
    """Relabel extension groups granted this batch into batch-position
    order (== the serial pool layout), in place."""
    B = alloc_pos.shape[0]
    PE = cfg.ext_pool_pairs
    dev = alloc_pos.device
    did = alloc_pos >= 0
    order = torch.argsort(torch.where(did, alloc_pos, 2 ** 31 - 1),
                          stable=True)                 # granters first
    did_s = did[order]
    old_s = alloc_idx[order][did_s]
    new_s = (int(table.ext_count) - int(did.sum())
             + torch.arange(B, dtype=I64, device=dev))[did_s]
    fwd = torch.arange(PE, dtype=I64, device=dev)
    fwd[old_s] = new_s
    inv = torch.arange(PE, dtype=I64, device=dev)
    inv[new_s] = old_s
    emap = table.ext_map.to(I64)
    table.ext_map.copy_(torch.where(emap >= 0, fwd[emap.clamp(min=0)], -1))
    # the permutation moves only the rows granted this batch
    table.ext_keys[new_s] = table.ext_keys[inv[new_s]]
    table.ext_vals[new_s] = table.ext_vals[inv[new_s]]


def _fp_side_words(cfg, P, okf, pair, slot, fpv, device):
    """(fclear, fnew) flat (2P,) int32 masks of the claimed main slots'
    fp fields: disjoint 2-bit fields, so scatter-adds compose like the
    serial per-op read-modify-writes."""
    S = cfg.slots_per_pair
    fw = slot.clamp(max=S - 1) // _FPW
    fsh = FP_SLOT_BITS * (slot % _FPW)
    at = (pair * 2 + fw)[okf]
    fclear = torch.zeros(2 * P, dtype=I32, device=device).index_add_(
        0, at, to_i32((FP_MASK << fsh)[okf]))
    fnew = torch.zeros(2 * P, dtype=I32, device=device).index_add_(
        0, at, to_i32(((fpv & FP_MASK) << fsh)[okf]))
    return fclear, fnew


def _apply_fp(table, fclear, fnew) -> None:
    fp = table.fp.view(-1)
    fp.bitwise_and_(~fclear).bitwise_or_(fnew)


def _insert_fused(cfg: ContinuityConfig, table: ContinuityTable, keys, vals,
                  active):
    """All insert waves fused into one rank-indexed bit-select pass.

    The op of intra-cohort rank r takes the (r+1)-th empty candidate of the
    PRE-batch indicator word; cohorts where the two parities of a pair can
    collide on the middle SBuckets are flagged unsafe and left for the
    residual wave loop.  Returns ``(table, ok, unsafe_sorted, idx_s,
    grant_pos, grant_idx)``."""
    B = keys.shape[0]
    P = cfg.num_pairs
    S, seg, E = cfg.slots_per_pair, cfg.seg_slots, cfg.ext_slots
    dev = keys.device
    pair, parity = locate(cfg, keys)

    cls = torch.where(active, pair * 2 + parity, 2 * P)
    cls_s, idx_s = _stable_order(cls)
    act = cls_s < 2 * P
    pair_s = (cls_s >> 1).clamp(max=P - 1)
    par_s = cls_s & 1
    r2 = _cohort_ranks(cls_s)                 # rank within (pair, parity)

    ind = u32(table.indicator[pair_s])
    has_ext = table.ext_map[pair_s] >= 0
    main_mask = (1 << seg) - 1
    canon = _canonical_occupancy(cfg, ind, par_s)
    own_empty = popcount(~canon & main_mask)
    spill = act & (r2 >= own_empty)           # would leave its main segment

    # cohort safety: per-(pair, parity) op count + spill flag, ONE scatter
    rec = torch.where(act, 1 + (spill.to(I64) << 16), 0)
    cnt = torch.zeros(P * 2, dtype=I64, device=dev).index_add_(
        0, pair_s * 2 + par_s, rec)
    own = cnt[pair_s * 2 + par_s]
    oth = cnt[pair_s * 2 + 1 - par_s]
    pair_empty = popcount(~ind & ((1 << S) - 1))
    unsafe = act & (oth > 0) & (
        ((own >> 16) + (oth >> 16) > 0)
        | ((own & 0xFFFF) + (oth & 0xFFFF) > pair_empty))
    go = act & ~unsafe

    # extension grants, in batch order (== serial grant order)
    gpos = torch.full((B,), -1, dtype=I64, device=dev)
    gidx = torch.full((B,), -1, dtype=I64, device=dev)
    if cfg.ext_frac > 0 and E:
        ext_count = int(table.ext_count)
        pool_left = cfg.ext_pool_pairs - ext_count
        want = go & (r2 == own_empty) & ~has_ext
        if pool_left > 0 and bool(want.any()):
            wb = torch.zeros(B, dtype=torch.bool, device=dev)
            wb[idx_s] = want
            grank = torch.cumsum(wb.to(I64), 0) - 1
            gb = wb & (grank < pool_left)
            grant = gb[idx_s]
            new_eidx = (ext_count + grank)[idx_s]
            gpos = torch.where(gb, torch.arange(B, device=dev), -1)
            gidx = torch.where(gb, ext_count + grank, -1)
            # at most one grant per pair: a spilling op of a safe cohort is
            # single-parity and only rank == #empty triggers
            table.ext_map[pair_s[grant]] = new_eidx[grant].to(I32)
            table.ext_count.add_(grant.sum().to(I32))
    eidx = table.ext_map[pair_s].to(I64)

    # rank-indexed slot selection on the canonical empty word
    ext_bits = ((1 << E) - 1) << seg if E else 0
    empty = ~canon & (main_mask | torch.where(eidx >= 0, ext_bits, 0))
    ok = go & (r2 < popcount(empty))
    slot = _slot_of(cfg, _select_bit(empty, r2), par_s)
    k_s, v_s = keys[idx_s], vals[idx_s]

    # phase 1: payload rows (committed ops claim distinct (pair, slot))
    is_ext = slot >= S
    m = ok & ~is_ext
    flat = (pair_s * S + slot)[m]
    table.keys.view(P * S, KEY_LANES)[flat] = k_s[m]
    table.vals.view(P * S, VAL_LANES)[flat] = v_s[m]
    e = ok & is_ext
    if bool(e.any()):
        EX = cfg.ext_slots
        PE = table.ext_keys.shape[0]
        eflat = (eidx.clamp(min=0) * EX + (slot - S).clamp(min=0))[e]
        table.ext_keys.view(PE * EX, KEY_LANES)[eflat] = k_s[e]
        table.ext_vals.view(PE * EX, VAL_LANES)[eflat] = v_s[e]

    # fingerprint fields of the committed main slots, then phase 2: the
    # one-word indicator commits (bits of one pair are disjoint, so a
    # scatter-add is the batch of independent ORs) and version bumps
    fclear, fnew = _fp_side_words(cfg, P, m, pair_s, slot, fingerprint(k_s),
                                  dev)
    p_ok = pair_s[ok]
    add = torch.zeros(P, dtype=I32, device=dev).index_add_(
        0, p_ok, to_i32(bit(slot[ok])))
    table.indicator.bitwise_or_(add)
    table.version.index_add_(0, p_ok, torch.ones_like(p_ok, dtype=I32))
    _apply_fp(table, fclear, fnew)
    table.count.add_(ok.sum().to(I32))

    okb = torch.zeros(B, dtype=torch.bool, device=dev)
    okb[idx_s] = ok
    return table, okb, unsafe, idx_s, gpos, gidx


def insert(cfg: ContinuityConfig, table: ContinuityTable, keys, vals,
           mask=None):
    """Server-side batched insert on the wave engine, in place. 2 PM
    writes/op (3 on the stash path).  Returns ``(table, ok, ledger)`` with
    the table object it was given, mutated."""
    keys, vals, active = batch_words(table.keys.device, keys, vals, mask)
    B = keys.shape[0]
    dev = keys.device
    table, ok, unsafe_s, idx_s, gpos, gidx = _insert_fused(
        cfg, table, keys, vals, active)

    if bool(unsafe_s.any()):
        # residual wave loop: only parity-contended cohorts (rare) run here
        unsafe = torch.zeros(B, dtype=torch.bool, device=dev)
        unsafe[idx_s] = unsafe_s
        pair, parity, rank, num_waves = _plan_waves(cfg, keys, unsafe)
        for w in range(num_waves):
            table, wok, wgrant, weidx = _insert_wave(
                cfg, table, keys, vals, pair, parity, rank == w)
            gpos = torch.where(wgrant, torch.arange(B, device=dev), gpos)
            gidx = torch.where(wgrant, weidx, gidx)
            ok = ok | wok

    n_stash = 0
    if cfg.stash_slots:
        fail = active & ~ok
        if bool(fail.any()):
            # stash fallback AFTER all main waves: op i's stash slot is the
            # (rank_i+1)-th free slot in ascending order
            T = cfg.stash_slots
            free = table.stash_meta == 0
            nth = torch.cumsum(fail.to(I64), 0) - 1
            sok = fail & (nth < free.sum())
            fs = torch.sort(torch.where(free, torch.arange(T, device=dev),
                                        T)).values
            sidx = fs[nth.clamp(0, T - 1)][sok]
            pair, _ = locate(cfg, keys)
            pw = pair[sok]
            table.fp.view(-1).index_add_(
                0, pw * 2 + 1, torch.full_like(pw, _STASH_ONE, dtype=I32))
            table.stash_keys[sidx] = keys[sok]
            table.stash_vals[sidx] = vals[sok]
            table.version.index_add_(0, pw, torch.ones_like(pw, dtype=I32))
            table.stash_meta[sidx] = (pw + 1).to(I32)
            n_stash = sok.sum()
            table.count.add_(n_stash.to(I32))
            ok = ok | sok

    if cfg.ext_frac > 0 and bool((gpos >= 0).any()):
        _reorder_ext_pool(cfg, table, gpos, gidx)
    ctr = pmem.CostLedger.zero(dev).add(pm_writes=2 * ok.sum() + n_stash,
                                        ops=active.sum())
    return table, ok, ctr


def _gather_candidate_keys(cfg: ContinuityConfig, table: ContinuityTable,
                           pair, parity, ext_allowed):
    """``_gather_candidates`` minus the value gathers."""
    cand, cand_keys, valid, slot_ok, _, _, _ = _candidate_keys(
        cfg, table, pair, parity, ext_allowed)
    return cand, cand_keys, valid, slot_ok


def _stash_release(table, pw, sidx) -> None:
    """Free stash rows and decrement their pairs' count bytes."""
    table.stash_meta[sidx] = 0
    table.fp.view(-1).index_add_(
        0, pw * 2 + 1, torch.full_like(pw, -_STASH_ONE, dtype=I32))


def _delete_wave(cfg: ContinuityConfig, table: ContinuityTable, keys,
                 pair, parity, m):
    """One delete wave over the ops in ``m`` (distinct pairs), in place."""
    B = keys.shape[0]
    idx = m.nonzero().squeeze(1)
    k, p, par = keys[idx], pair[idx], parity[idx]
    no = torch.zeros(idx.shape[0], dtype=torch.bool, device=keys.device)
    cand, ckeys, valid, _ = _gather_candidate_keys(cfg, table, p, par,
                                                   ext_allowed=no)
    match = valid & (ckeys == k[:, None, :]).all(-1)
    okw = match.any(-1)
    slot = _take(cand, _first(match))
    word = u32(table.indicator[p]) & ~torch.where(okw, bit(slot.clamp(min=0)),
                                                  0)
    _commit_indicator(table, okw, p, word)          # the ONE PM write
    pm = okw.sum()
    if cfg.stash_slots:
        shit, sidx = _stash_find(cfg, table, k, p)
        sok = ~okw & shit
        table.version.index_add_(0, p[sok], torch.ones_like(p[sok], dtype=I32))
        _stash_release(table, p[sok], sidx[sok])
        okw = okw | sok
        pm = pm + 2 * sok.sum()
    table.count.sub_(okw.sum().to(I32))
    ok = torch.zeros(B, dtype=torch.bool, device=keys.device)
    ok[idx] = okw
    return table, ok, pm


def _mutation_match(cfg: ContinuityConfig, table: ContinuityTable, keys,
                    pair, parity, *, probe="gather"):
    """Pre-batch match resolution shared by the fused update/delete passes.

    Returns ``(found, mslot)``: the first main/extension slot holding each
    key, -1 on miss.  ``probe``: ``"gather"`` is the plain candidate
    gather; ``"kernel"``/``"reference"`` run the mutation-plan kernel
    wrapper / its plain version over the main segment plus the extension
    tail.  All backends are result-identical."""
    B = keys.shape[0]
    if probe == "gather":
        no = torch.zeros(B, dtype=torch.bool, device=keys.device)
        cand, ckeys, valid, _ = _gather_candidate_keys(
            cfg, table, pair, parity, ext_allowed=no)
        match = valid & (ckeys == keys[:, None, :]).all(-1)
        found = match.any(-1)
        return found, torch.where(found, _take(cand, _first(match)), -1)
    from repro_torch.kernels import ops as K
    mmain, _, _ = K.mutation_plan(cfg, table, keys,
                                  use_kernel=probe == "kernel")
    found_m = mmain >= 0
    efound, efirst = _ext_tail(cfg, table, keys, pair, ~found_m)
    found = found_m | efound
    return found, torch.where(
        found_m, mmain.to(I64),
        torch.where(efound, cfg.slots_per_pair + efirst, -1))


def _ext_tail(cfg, table, keys, pair, need):
    """Extension-slot match behind a kernel probe, for the queries in
    ``need`` whose pair has added SBuckets (all others report no match):
    ``(efound, efirst)``, ``efirst`` the slot's index in the group.  The
    reference computes it for every query and masks; the results agree
    wherever they are used."""
    B = keys.shape[0]
    efound = torch.zeros(B, dtype=torch.bool, device=keys.device)
    efirst = torch.zeros(B, dtype=I64, device=keys.device)
    S, E = cfg.slots_per_pair, cfg.ext_slots
    if not E:
        return efound, efirst
    eidx = table.ext_map[pair].to(I64)
    idx = (need & (eidx >= 0)).nonzero().squeeze(1)
    if idx.numel():
        p = pair[idx]
        shifts = S + torch.arange(E, device=keys.device)
        ebits = (u32(table.indicator[p])[:, None] >> shifts[None]) & 1
        ematch = (ebits == 1) & (
            table.ext_keys[eidx[idx]] == keys[idx][:, None, :]).all(-1)
        efound[idx] = ematch.any(-1)
        efirst[idx] = _first(ematch)
    return efound, efirst


def _dup_targets(cfg: ContinuityConfig, pair, cm, mslot, cs, sidx):
    """Per-op flag: does another active op resolve to the SAME target (main
    or extension slot, or stash row)?  Duplicate targets <=> duplicate
    keys in the batch.  Counted by a sort of the flat locations (the
    reference scatter-counts over the whole location space)."""
    P, TB = cfg.num_pairs, cfg.total_bits
    loc = torch.where(cm, pair * TB + mslot.clamp(min=0), P * TB + sidx)
    hit = cm | cs
    out = torch.zeros_like(hit)
    if bool(hit.any()):
        _, inv, cnt = torch.unique(loc[hit], return_inverse=True,
                                   return_counts=True)
        out[hit] = cnt[inv] > 1
    return out


def _stash_state(cfg, table, keys, pair, found):
    if cfg.stash_slots:
        shit, sidx = _stash_find(cfg, table, keys, pair)
        return ~found & shit, sidx
    z = torch.zeros(keys.shape[0], dtype=I64, device=keys.device)
    return z.bool(), z


def _delete_fused(cfg: ContinuityConfig, table: ContinuityTable, keys,
                  active, *, probe):
    """All delete waves fused into one pass (distinct keys clear disjoint
    bits of the pre-batch table); duplicate-target ops are flagged unsafe
    and left untouched.  Returns ``(table, ok, pm, unsafe)``."""
    P = cfg.num_pairs
    dev = keys.device
    pair, parity = locate(cfg, keys)
    found, mslot = _mutation_match(cfg, table, keys, pair, parity,
                                   probe=probe)
    cm = active & found
    in_stash, sidx = _stash_state(cfg, table, keys, pair, found)
    cs = active & in_stash
    unsafe = _dup_targets(cfg, pair, cm, mslot, cs, sidx)
    okm = cm & ~unsafe
    oks = cs & ~unsafe

    # phase 2 only: clear bits (disjoint per pair) + version bumps
    clear = torch.zeros(P, dtype=I32, device=dev).index_add_(
        0, pair[okm], to_i32(bit(mslot[okm])))
    p_all = pair[okm | oks]
    table.indicator.bitwise_and_(~clear)
    table.version.index_add_(0, p_all, torch.ones_like(p_all, dtype=I32))
    pm = okm.sum()
    if cfg.stash_slots and bool(oks.any()):
        _stash_release(table, pair[oks], sidx[oks])
    pm = pm + 2 * oks.sum()
    ok = okm | oks
    table.count.sub_(ok.sum().to(I32))
    return table, ok, pm, unsafe


def delete(cfg: ContinuityConfig, table: ContinuityTable, keys, mask=None,
           *, probe: str = "gather"):
    """Server-side batched delete on the wave engine, in place. 1 PM
    write/op (2 for stash entries).  ``probe`` selects the match backend
    (see `_mutation_match`).  Returns ``(table, ok, ledger)``."""
    keys, _, active = batch_words(table.keys.device, keys, mask=mask)
    table, ok, pm, unsafe = _delete_fused(cfg, table, keys, active,
                                          probe=probe)
    if bool(unsafe.any()):
        pair, parity, rank, num_waves = _plan_waves(cfg, keys, unsafe)
        for w in range(num_waves):
            table, wok, wpm = _delete_wave(cfg, table, keys, pair, parity,
                                           rank == w)
            ok = ok | wok
            pm = pm + wpm
    ctr = pmem.CostLedger.zero(keys.device).add(pm_writes=pm,
                                                ops=active.sum())
    return table, ok, ctr


def _update_wave(cfg: ContinuityConfig, table: ContinuityTable, keys, vals,
                 pair, parity, m):
    """One out-of-place update wave over the ops in ``m``, in place."""
    B = keys.shape[0]
    S = cfg.slots_per_pair
    idx = m.nonzero().squeeze(1)
    k, v, p, par = keys[idx], vals[idx], pair[idx], parity[idx]
    no = torch.zeros(idx.shape[0], dtype=torch.bool, device=keys.device)
    cand, ckeys, valid, slot_ok = _gather_candidate_keys(
        cfg, table, p, par, ext_allowed=no)
    match = valid & (ckeys == k[:, None, :]).all(-1)
    found = match.any(-1)
    old = _take(cand, _first(match))
    empty = (~valid) & slot_ok
    new = _take(cand, _first(empty))
    has_empty = empty.any(-1)
    if cfg.stash_slots:
        shit, sidx = _stash_find(cfg, table, k, p)
        in_stash = ~found & shit
        found = found | in_stash
    else:
        in_stash = torch.zeros_like(found)
    okw = found & has_empty
    okm = okw & ~in_stash
    oks = okw & in_stash
    ext_idx = table.ext_map[p].to(I64).clamp(min=0)
    _scatter_payload(table, okw, p, new, ext_idx, k, v, S)       # phase 1
    _fp_store(table, okw & (new < S), p, new, fingerprint(k))
    flip = torch.where(okm, bit(old.clamp(min=0)), 0) | bit(new)
    word = u32(table.indicator[p]) ^ torch.where(okw, flip, 0)
    _commit_indicator(table, okw, p, word)                        # phase 2
    pm = 2 * okm.sum()
    if cfg.stash_slots:
        _stash_release(table, p[oks], sidx[oks])
        pm = pm + 3 * oks.sum()
    ok = torch.zeros(B, dtype=torch.bool, device=keys.device)
    ok[idx] = okw
    return table, ok, pm


def _update_fused(cfg: ContinuityConfig, table: ContinuityTable, keys, vals,
                  active, *, probe):
    """All update waves fused into one rank-indexed pass.

    Each op's OLD slot comes from the pre-batch table; new-slot allocation
    is replayed rank by rank on a copy of the indicator words, then the
    batch commits in one scatter round.  Duplicate-target cohorts poison
    their whole pair and are left for the residual wave loop.  Returns
    ``(table, ok, pm, unsafe)``."""
    B = keys.shape[0]
    P = cfg.num_pairs
    S, seg, E = cfg.slots_per_pair, cfg.seg_slots, cfg.ext_slots
    dev = keys.device
    pair, parity = locate(cfg, keys)
    found, mslot = _mutation_match(cfg, table, keys, pair, parity,
                                   probe=probe)
    in_stash, sidx = _stash_state(cfg, table, keys, pair, found)
    cm = active & found
    cs = active & in_stash
    dup = _dup_targets(cfg, pair, cm, mslot, cs, sidx)
    # a duplicate target serializes its WHOLE pair
    pdup = torch.zeros(P, dtype=torch.bool, device=dev)
    pdup[pair[dup]] = True
    unsafe = active & pdup[pair]
    cand_op = (cm | cs) & ~unsafe

    # rank-sequential new-slot allocation on the word copy
    _, _, rank, num_waves = _plan_waves(cfg, keys, cand_op)
    main_mask = (1 << seg) - 1
    ext_bits = ((1 << E) - 1) << seg if E else 0
    has_ext = table.ext_map[pair] >= 0
    is_m = cand_op & found                   # main/ext match frees its bit
    evo = table.indicator.clone()
    new_slot = torch.zeros(B, dtype=I64, device=dev)
    ok = torch.zeros(B, dtype=torch.bool, device=dev)
    for w in range(num_waves):
        sel = (cand_op & (rank == w)).nonzero().squeeze(1)
        p, par = pair[sel], parity[sel]
        word = u32(evo[p])
        canon = _canonical_occupancy(cfg, word, par)
        empty = ~canon & (main_mask | torch.where(has_ext[sel], ext_bits, 0))
        okw = empty != 0
        ns = _slot_of(cfg, _select_bit(empty, torch.zeros_like(empty)), par)
        flip = bit(ns) | torch.where(is_m[sel], bit(mslot[sel].clamp(min=0)),
                                     0)
        evo[p[okw]] = to_i32(word ^ flip)[okw]
        new_slot[sel[okw]] = ns[okw]
        ok[sel[okw]] = True
    okm = ok & ~in_stash
    oks = ok & in_stash
    eidx = table.ext_map[pair].to(I64).clamp(min=0)

    # phase 1: payload rows (pairwise-distinct claimed slots)
    is_ext = new_slot >= S
    okp = ok & ~is_ext
    flat = (pair * S + new_slot)[okp]
    table.keys.view(P * S, KEY_LANES)[flat] = keys[okp]
    table.vals.view(P * S, VAL_LANES)[flat] = vals[okp]
    e = ok & is_ext
    if bool(e.any()):
        EX = cfg.ext_slots
        PE = table.ext_keys.shape[0]
        eflat = (eidx * EX + (new_slot - S).clamp(min=0))[e]
        table.ext_keys.view(PE * EX, KEY_LANES)[eflat] = keys[e]
        table.ext_vals.view(PE * EX, VAL_LANES)[eflat] = vals[e]

    # fp fields of the claimed slots, version bumps, and phase 2: the
    # indicator words straight from the evolved copy
    fclear, fnew = _fp_side_words(cfg, P, okp, pair, new_slot,
                                  fingerprint(keys), dev)
    p_ok = pair[ok]
    table.version.index_add_(0, p_ok, torch.ones_like(p_ok, dtype=I32))
    _apply_fp(table, fclear, fnew)
    table.indicator.copy_(evo)
    pm = 2 * okm.sum()
    if cfg.stash_slots and bool(oks.any()):
        # the commit made the main copy win by probe priority, so the meta
        # clear only removes a shadowed entry
        _stash_release(table, pair[oks], sidx[oks])
    pm = pm + 3 * oks.sum()
    return table, ok, pm, unsafe


def update(cfg: ContinuityConfig, table: ContinuityTable, keys, vals,
           mask=None, *, probe: str = "gather"):
    """Server-side batched out-of-place update on the wave engine, in
    place.  2 PM writes/op; both bit flips land in ONE indicator store (3
    writes when the op relocates a stash entry).  ``probe`` selects the
    match backend.  Returns ``(table, ok, ledger)``."""
    keys, vals, active = batch_words(table.keys.device, keys, vals, mask)
    table, ok, pm, unsafe = _update_fused(cfg, table, keys, vals, active,
                                          probe=probe)
    if bool(unsafe.any()):
        pair, parity, rank, num_waves = _plan_waves(cfg, keys, unsafe)
        for w in range(num_waves):
            table, wok, wpm = _update_wave(cfg, table, keys, vals, pair,
                                           parity, rank == w)
            ok = ok | wok
            pm = pm + wpm
    ctr = pmem.CostLedger.zero(keys.device).add(pm_writes=pm,
                                                ops=active.sum())
    return table, ok, ctr


# ---------------------------------------------------------------------------
# parallel (conflict-resolved) insert — one wave of the engine; same-pair
# duplicates past the first are reported for retry (batch-order priority ==
# lock order), and extension groups can be granted
# ---------------------------------------------------------------------------

def insert_parallel(cfg: ContinuityConfig, table: ContinuityTable, keys,
                    vals, mask=None):
    """One insert wave, in place: ``(table, ok, retry)``."""
    keys, vals, active = batch_words(table.keys.device, keys, vals, mask)
    pair, parity, rank, _ = _plan_waves(cfg, keys, active)
    table, ok, _, _ = _insert_wave(cfg, table, keys, vals, pair, parity,
                                   rank == 0)
    return table, ok, active & ~ok


# ---------------------------------------------------------------------------
# resizing (paper §III-C "Log-free Resizing") + recovery
# ---------------------------------------------------------------------------

def extract_items(cfg: ContinuityConfig, table: ContinuityTable):
    """All storage slots as flat ``(keys, vals, live)``: main rows, the
    extension pool in pool order, then the stash (stash geometries only)."""
    P, S, E = cfg.num_pairs, cfg.slots_per_pair, cfg.ext_slots
    PE = cfg.ext_pool_pairs
    dev = table.keys.device
    ind = u32(table.indicator)[:, None]
    mmask = ((ind >> torch.arange(S, device=dev)) & 1) == 1
    ebits = ((ind >> (S + torch.arange(E, device=dev))) & 1) == 1
    has = table.ext_map >= 0
    # pair-order extension validity scattered into pool order
    pool_mask = torch.zeros((PE, E), dtype=torch.bool, device=dev)
    pool_mask[table.ext_map[has].to(I64)] = ebits[has]
    keys = [table.keys.reshape(P * S, KEY_LANES),
            table.ext_keys.reshape(PE * E, KEY_LANES)]
    vals = [table.vals.reshape(P * S, VAL_LANES),
            table.ext_vals.reshape(PE * E, VAL_LANES)]
    mask = [mmask.reshape(P * S), pool_mask.reshape(PE * E)]
    if cfg.stash_slots:
        keys.append(table.stash_keys)
        vals.append(table.stash_vals)
        mask.append(table.stash_meta != 0)
    return torch.cat(keys), torch.cat(vals), torch.cat(mask)


def restart(cfg: ContinuityConfig, table: ContinuityTable):
    """Paper §III-C restart of a (possibly crashed) table, on its device:
    a pure function of the commit words.  Returns ``(new table, scanned,
    cleared)``.  A live stash entry is cleared when its pair's committed
    row (main or extension slots) holds its key — a stash relocation
    crashed after the row commit — or when an earlier live entry holds the
    same (pair, key); then the per-pair stash count bytes, ``count`` and
    ``ext_count`` are re-derived.  ``scanned`` counts the live stash
    entries read, ``cleared`` the entries cleared.  The port's one continuity
    restart: the store's ``recover`` and the crash-consistency handler's
    both run it."""
    t = ContinuityTable(*(x.clone() for x in table))
    P, S, E, T = cfg.num_pairs, cfg.slots_per_pair, cfg.ext_slots, \
        cfg.stash_slots
    dev = t.keys.device
    scanned = cleared = 0
    if T:
        idx = (t.stash_meta[:T] != 0).nonzero().squeeze(1)
        scanned = int(idx.numel())
        if scanned:
            pair = t.stash_meta[idx].to(I64) - 1
            k = t.stash_keys[idx]
            ind = u32(t.indicator[pair])[:, None]
            bits = (ind >> torch.arange(S, device=dev)) & 1
            in_row = ((bits == 1) & (t.keys[pair] == k[:, None, :]).all(-1)
                      ).any(-1)
            if E:
                e = t.ext_map[pair].to(I64)
                ebits = (ind >> (S + torch.arange(E, device=dev))) & 1
                in_row |= (e >= 0) & ((ebits == 1) & (
                    t.ext_keys[e.clamp(min=0)] == k[:, None, :]).all(-1)
                ).any(-1)
            _, first = row_groups(torch.cat([pair[:, None], k.to(I64)], 1))
            drop = in_row | ~first
            t.stash_meta[idx[drop]] = 0
            cleared = int(drop.sum())
        cnt = torch.bincount(t.stash_meta[:T].to(I64),
                             minlength=P + 1)[1:P + 1]
        low = u32(t.fp[:, 1]) & ((1 << STASH_CNT_SHIFT) - 1)
        t.fp[:, 1] = to_i32(low | (cnt << STASH_CNT_SHIFT))
    ind = u32(t.indicator)
    mapped = t.ext_map >= 0
    n = popcount(ind & ((1 << S) - 1)).sum()
    if E:
        n = n + (popcount((ind >> S) & ((1 << E) - 1)) * mapped).sum()
    if T:
        n = n + (t.stash_meta[:T] != 0).sum()
    t.count.fill_(int(n))
    t.ext_count.fill_(int(mapped.sum()))
    return t, scanned, cleared


def _grown_table(cfg: ContinuityConfig, table: ContinuityTable,
                 new_cfg: ContinuityConfig) -> ContinuityTable:
    """Empty ``new_cfg`` table whose versions all start one above the old
    table's unsigned maximum (mod 2**32, as the reference's uint32 add):
    stamps cached against the old geometry can then never compare equal
    to a post-resize stamp."""
    new = create(new_cfg, table.keys.device)
    new.version.copy_(to_i32(u32(table.version).max() + 1).expand(
        new_cfg.num_pairs))
    return new


def resize(cfg: ContinuityConfig, table: ContinuityTable, factor: int = 2,
           chunk: int = 1 << 22):
    """Rehash into a table with ``factor``x buckets (the batched path
    production resizing uses); the old table is left as it was.

    Items go in, in extraction order, as insert batches of up to ``chunk``
    slots (bounding the engine's temporaries at full size).  The chunks
    give the table a single batch of every item gives (the reference's
    one insert) as long as the grown table's extension pool does not run
    out inside a chunk: the wave engine then equals the serial scan, which
    a split into chunks does not change.  Where the pool runs out, the
    wave engine's grant order is not the serial one (ROADMAP.md Queue 3),
    and a chunked table can differ from the reference's.  A table of at
    most ``chunk`` slots goes in as one batch.  Returns
    ``(new_cfg, new_table)``."""
    new_cfg = cfg.grow(factor)
    new = _grown_table(cfg, table, new_cfg)
    keys, vals, mask = extract_items(cfg, table)
    for s in range(0, keys.shape[0], chunk):
        insert(new_cfg, new, keys[s:s + chunk], vals[s:s + chunk],
               mask[s:s + chunk])
    return new_cfg, new


def resize_stepwise(cfg, table, new_cfg, new_table, max_items: int):
    """Move up to ``max_items`` live items old->new, one at a time, with the
    paper's ordering: insert into new, commit, then delete from old.  Both
    tables are updated in place.  Returns ``(old, new, moved)``."""
    moved = 0
    one = torch.ones(1, dtype=torch.bool, device=table.keys.device)
    for _ in range(max_items):
        keys, vals, mask = extract_items(cfg, table)
        idx = int(torch.argmax(mask.to(torch.int8)))
        if not bool(mask[idx]):
            break
        k, v = keys[idx:idx + 1], vals[idx:idx + 1]
        new_table, ok, _ = _insert_one(new_cfg, new_table, k, v, one)
        table, _, _ = _delete_one(cfg, table, k, one)
        moved += int(ok.sum())
    return table, new_table, moved


def recover(cfg, old_table, new_cfg, new_table):
    """Paper §III-C recovery after a restart mid-resize, in place: each
    item still in the old table is deleted if it already reached the new
    table, otherwise moved (insert-to-new then delete-from-old)."""
    keys, vals, mask = extract_items(cfg, old_table)
    one = torch.ones(1, dtype=torch.bool, device=old_table.keys.device)
    for i in mask.nonzero().squeeze(1).tolist():
        k, v = keys[i:i + 1], vals[i:i + 1]
        if not bool(lookup(new_cfg, new_table, k).found[0]):
            _insert_one(new_cfg, new_table, k, v, one)
        _delete_one(cfg, old_table, k, one)
    return old_table, new_table


def items_host(cfg, table) -> dict:
    """Live items as ``{key bytes: value bytes}`` (the reference's uint32
    images; tests only)."""
    keys, vals, mask = extract_items(cfg, table)
    kn = keys[mask].cpu().numpy().view(np.uint32)
    vn = vals[mask].cpu().numpy().view(np.uint32)
    return {k.tobytes(): v.tobytes() for k, v in zip(kn, vn)}


# ---------------------------------------------------------------------------
# incremental split — online resize, one bucket-group cohort per step
# ---------------------------------------------------------------------------
# Growing ``num_buckets`` by an even factor keeps a key's bucket parity and
# maps every item homed at old pair p into a new pair p + k*P (k < factor),
# so ONE old pair is a closed rehash cohort: copy its items into the new
# table (insert-if-absent, so a replayed step is idempotent), flip the
# pair's split token — the commit point that switches routing — then
# delete the moved items from the old table.  Lookups and writes for a key
# go to the new table iff ``token[old_pair] != 0``.

class SplitState(NamedTuple):
    """In-flight incremental resize.  ``token`` is updated in place, like
    the two tables, so every handle of one split names the same live
    state; a step replayed from an older handle is idempotent."""

    token: torch.Tensor     # (P_old,) int32 — 1 = cohort cut over
    next_pair: int          # first pair not yet moved


def split_begin(cfg: ContinuityConfig, table: ContinuityTable,
                factor: int = 2):
    """Open an incremental split to a ``factor``x table.  Returns
    ``(new_cfg, new_table, state)``; the old table is untouched."""
    if factor < 2 or factor % 2:
        raise ValueError(f"parity-preserving factors only: {factor}")
    new_cfg = cfg.grow(factor)
    new = _grown_table(cfg, table, new_cfg)
    token = torch.zeros(cfg.num_pairs, dtype=I32, device=table.keys.device)
    return new_cfg, new, SplitState(token=token, next_pair=0)


def cohort_items(cfg: ContinuityConfig, table: ContinuityTable, pair: int):
    """Candidate rows of ONE pair as copies: ``(keys, vals, live)`` over
    its S main slots, E extension slots and (stash geometries) the T
    stash entries."""
    S, E, T = cfg.slots_per_pair, cfg.ext_slots, cfg.stash_slots
    dev = table.keys.device
    ind = u32(table.indicator[pair])
    mmask = ((ind >> torch.arange(S, device=dev)) & 1) == 1
    eidx = table.ext_map[pair].to(I64)
    ebits = ((ind >> (S + torch.arange(E, device=dev))) & 1) == 1
    emask = ebits & (eidx >= 0)
    safe_e = eidx.clamp(min=0)
    keys = [table.keys[pair], table.ext_keys[safe_e]]
    vals = [table.vals[pair], table.ext_vals[safe_e]]
    mask = [mmask, emask]
    if T:
        keys.append(table.stash_keys)
        vals.append(table.stash_vals)
        mask.append(table.stash_meta == pair + 1)
    return torch.cat(keys), torch.cat(vals), torch.cat(mask)


def split_step(cfg: ContinuityConfig, table: ContinuityTable,
               new_cfg: ContinuityConfig, new_table: ContinuityTable,
               state: SplitState, budget: int = 1):
    """Move up to ``budget`` cohorts, one insert and one delete batch
    each (the paper's insert-to-new -> commit -> delete-from-old order,
    with the token flip as the single routing commit point).  Both tables
    and the token are updated in place.  Returns ``(table, new_table,
    state, moved)``."""
    P = cfg.num_pairs
    start = state.next_pair
    stop = min(start + int(budget), P)
    moved = 0
    for p in range(start, stop):
        kc, vc, mc = cohort_items(cfg, table, p)
        # the live rows only, in row order: the inactive ones change
        # nothing, and the batch stays small next to the stash's T rows
        kc, vc = kc[mc], vc[mc]
        n = kc.shape[0]
        if n:
            already = lookup(new_cfg, new_table, kc).found
            insert(new_cfg, new_table, kc, vc, ~already)   # idempotent copy
        state.token[p] = 1                                 # cutover
        if n:
            delete(cfg, table, kc)                         # cleanup
        moved += n
    return table, new_table, state._replace(next_pair=stop), moved


def split_done(cfg: ContinuityConfig, state: SplitState) -> bool:
    return state.next_pair >= cfg.num_pairs


def split_route(cfg: ContinuityConfig, state: SplitState, keys):
    """(B,) bool — True where the key's cohort has cut over (route to new)."""
    keys = as_words(keys, KEY_LANES, state.token.device)
    pair, _ = locate(cfg, keys)
    return state.token[pair] != 0


def split_lookup(cfg: ContinuityConfig, table: ContinuityTable,
                 new_cfg: ContinuityConfig, new_table: ContinuityTable,
                 state: SplitState, keys) -> LookupResult:
    """Token-routed dual read during a split: each key consults exactly the
    table its token names (the copy phase holds items in BOTH tables, but
    the un-flipped token keeps the old copy authoritative until cutover)."""
    keys = as_words(keys, KEY_LANES, table.keys.device)
    cut = split_route(cfg, state, keys)
    r_old = lookup(cfg, table, keys)
    r_new = lookup(new_cfg, new_table, keys)

    def pick(a, b):
        return torch.where(cut.reshape(cut.shape + (1,) * (a.dim() - 1)),
                           b, a)
    return LookupResult(*(pick(a, b) for a, b in zip(r_old, r_new)))
