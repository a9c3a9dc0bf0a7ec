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

Only the wave engine is ported; the serial ``lax.scan`` oracles, resize /
split, ``scan_plan`` and ``insert_parallel`` are not part of this port yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import pmem
from repro_torch.core.hashfn import hash128, hash128_2
from repro_torch.core.words import (as_words, bit, popcount, resolve_device,
                                    to_i32, u32)

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


def _candidate_keys(cfg, table, pair, parity, ext_allowed):
    probe = torch.as_tensor(_probe_order(cfg), device=pair.device).to(I64)
    cand = probe[parity]                             # (B, C)
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
    READ; priority main > extension > stash.  A dense (B, T) compare, as
    in the reference."""
    found_me = found
    home = pair.to(I32) + 1
    smatch = (table.stash_meta[None, :] == home[:, None]) & (
        table.stash_keys[None, :, :] == keys[:, None, :]).all(-1)
    sfound = smatch.any(-1) & ~found
    sfirst = _first(smatch)
    values = torch.where(sfound[:, None], table.stash_vals[sfirst], values)
    slot = torch.where(sfound, cfg.total_bits + sfirst, slot)
    reads = reads + ((stash_count(table, pair) > 0) & ~found_me).to(I64)
    return found | sfound, values, slot, reads


def lookup(cfg: ContinuityConfig, table: ContinuityTable,
           keys) -> LookupResult:
    """Batched client read: ONE contiguous segment fetch per key (+1 iff the
    pair has added SBuckets and the main segment missed, +1 iff the pair's
    stash count byte is non-zero and both main and extension missed)."""
    keys = _keys_in(table, keys)
    pair, parity = locate(cfg, keys)
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


def _batch_arrays(table: ContinuityTable, keys, vals=None, mask=None):
    keys = _keys_in(table, keys)
    B = keys.shape[0]
    if vals is not None:
        vals = _keys_in(table, vals, VAL_LANES)
    if mask is None:
        active = torch.ones(B, dtype=torch.bool, device=keys.device)
    elif isinstance(mask, torch.Tensor):
        active = mask.reshape(B).to(device=keys.device, dtype=torch.bool)
    else:
        active = torch.from_numpy(
            np.asarray(mask, dtype=bool).reshape(B)).to(keys.device)
    return keys, vals, active


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
    keys, vals, active = _batch_arrays(table, keys, vals, mask)
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


def _stash_match(cfg, table: ContinuityTable, keys, pair):
    """(B, T) bool: stash entries holding ``keys`` homed at ``pair``."""
    home = pair.to(I32) + 1
    return (table.stash_meta[None, :] == home[:, None]) & (
        table.stash_keys[None, :, :] == keys[:, None, :]).all(-1)


def _stash_match_gated(cfg, table: ContinuityTable, keys, pair):
    """`_stash_match`, skipped (all-False) while no pair has a live stash
    entry — one count-byte reduction gates the (B, T) compare."""
    if bool(((table.fp[:, 1] >> STASH_CNT_SHIFT) & 0xFF).any()):
        return _stash_match(cfg, table, keys, pair)
    return torch.zeros((keys.shape[0], cfg.stash_slots), dtype=torch.bool,
                       device=keys.device)


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
        smatch = _stash_match(cfg, table, k, p)
        sok = ~okw & smatch.any(-1)
        sidx = _first(smatch)
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
        smatch = _stash_match_gated(cfg, table, keys, pair)
        return ~found & smatch.any(-1), _first(smatch)
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
    keys, _, active = _batch_arrays(table, keys, mask=mask)
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
        smatch = _stash_match(cfg, table, k, p)
        in_stash = ~found & smatch.any(-1)
        sidx = _first(smatch)
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
    keys, vals, active = _batch_arrays(table, keys, vals, mask)
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
