"""Per-scheme consistency handlers: traced write paths + recovery.

Port of ``repro.consistency.schemes``: the handlers work on numpy states,
as the reference's do; routing (hash -> pair/bucket, the wave schedule)
runs the port's own functions on the store's device, and tables cross the
boundary through ``repro_torch.convert``.

One handler per registered scheme, each providing:

  * ``trace_one``  — emit the ordered `PMStore` sequence of ONE op (the
    instrumented twin of the scheme's write path; final states are
    semantically identical to the scheme's own serial op, which the crash
    tests assert);
  * ``visible``    — the durable item set of a (possibly crashed) PM
    image, derived exactly the way a reader would: commit words first,
    payload only where the commit bit is set;
  * ``recover``    — the scheme's restart procedure on a crashed image,
    returning the repaired state plus a `RecoveryReport` of what it had
    to read and fix.

Consistency disciplines reproduced (the paper's Table I contrast):

  scheme      discipline                                recovery input
  ---------   ---------------------------------------   -----------------
  continuity  payload -> ONE atomic indicator commit    indicator words ONLY
  level       out-of-place + token commit; undo log     token words + undo log
              on the in-place update fallback;            + duplicate scan
              5-store crash-safe slot movement
  pfarm       RECIPE redo logging around every op       token words + FULL
              (log entry, commit, stores, invalidate)     redo-log replay
  dense       split commit on insert/delete; update     live bits only — torn
              is an UNPROTECTED in-place store            updates survive (the
                                                          matrix's neg. control)

States are numpy dicts (see `repro_torch.consistency.trace`); routing
decisions (hash -> pair/bucket) call the scheme modules' own hash
functions once per batch, on the store's device, so traced placement can
never drift from the real one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import repro_torch.core.continuity as ch
import repro_torch.core.dense as dn
import repro_torch.core.level as lv
import repro_torch.core.pfarm as pf
from repro_torch import convert
from repro_torch.consistency.recovery import RecoveryReport, popcount
from repro_torch.consistency.trace import (LOG, PMStore, PMTrace, State,
                                           SubWrite, TraceOp, apply_store,
                                           copy_state)
from repro_torch.core.hashfn import hash128, hash128_2

U32 = np.uint32
KL = ch.KEY_LANES
VL = ch.VAL_LANES
SLOT_BYTES = ch.SLOT_BYTES

LOG_ROWS = 64        # PM log region: entries (reused round-robin per op id)
LOG_LANES = 32       # uint32 lanes per entry (status word + images)

# log entry status (lane 0)
L_FREE, L_COMMITTED = 0, 1


def _key_bytes(k: np.ndarray) -> bytes:
    return np.asarray(k, U32).tobytes()


def host_words(x, lanes: int) -> np.ndarray:
    """Keys or values (numpy, or int32 word tensors on any device) as a
    (B, lanes) uint32 numpy array: the reference's images."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
        if x.dtype == np.int32:
            x = x.view(np.uint32)
    return np.asarray(x, U32).reshape(-1, lanes)


def _words_on(keys: np.ndarray, device) -> torch.Tensor:
    """uint32 key images -> int32 word tensor on ``device``."""
    return torch.from_numpy(np.array(keys, U32).view(np.int32)).to(device)


class _Handler:
    """Shared plumbing; subclasses fill in the scheme specifics."""

    name = "?"
    table_cls = None
    uses_log = False
    # table <-> numpy fields in the reference's dtypes (repro_torch.convert)
    to_numpy = None
    from_numpy = None

    def init_state(self, cfg, table) -> State:
        """A numpy state of ``table`` (a copy: never a live tensor's
        memory), or a copy of a state already given as one."""
        if isinstance(table, dict):
            state = copy_state(table)
        else:
            state = type(self).to_numpy(table)
        if self.uses_log and LOG not in state:
            state[LOG] = np.zeros((LOG_ROWS, LOG_LANES), U32)
        return state

    def state_to_table(self, cfg, state: State, device):
        """A port table on ``device`` holding ``state``'s table fields."""
        return type(self).from_numpy(
            {f: state[f] for f in self.table_cls._fields}, device)

    def route(self, cfg, keys: np.ndarray, device):
        """Per-batch hash routing (ONE call on ``device``; numpy out)."""
        raise NotImplementedError

    def trace_one(self, cfg, state: State, op: str, op_id: int,
                  key: np.ndarray, val: Optional[np.ndarray],
                  route, device) -> Tuple[List[PMStore], bool, str]:
        fn = getattr(self, f"_trace_{op}")
        return fn(cfg, state, op_id, key, val, route, device)

    def visible(self, cfg, state: State) -> Dict[bytes, bytes]:
        raise NotImplementedError

    def recover(self, cfg, state: State) -> Tuple[State, RecoveryReport]:
        raise NotImplementedError

    def rebuild_counts(self, cfg, state: State) -> State:
        """Recompute the derived (non-traced) counters IN PLACE semantics:
        returns a copy with count/alloc counters rebuilt, but performs NO
        repairs (no log replay, no duplicate scan) — for reconciling a
        fully-applied trace, where repairs must not run (e.g. level
        legitimately holds duplicate keys after a duplicate insert)."""
        raise NotImplementedError

    # -- log helpers (logging schemes) --------------------------------------
    def _log_addr(self, row: int, lane: int = 0) -> int:
        return 1 << 30 | row * LOG_LANES * 4 + lane * 4

    def _log_entry(self, op_id: int, row: int, lanes: np.ndarray,
                   nlanes: int) -> PMStore:
        """Write the entry body: lanes ``1..nlanes`` (the status lane is
        untouched — still FREE).  The store covers exactly the bytes it
        writes, so address ranges and torn-split counts agree."""
        return PMStore(op_id, "log", False, self._log_addr(row, 1),
                       4 * (nlanes - 1), True,
                       (SubWrite(LOG, (row, slice(1, nlanes)),
                                 lanes[1:nlanes]),))

    def _log_status(self, op_id: int, row: int, status: int,
                    kind: str) -> PMStore:
        return PMStore(op_id, kind, True, self._log_addr(row), 8, True,
                       (SubWrite(LOG, (row, 0), np.uint32(status)),))


# ---------------------------------------------------------------------------
# continuity — payload then ONE atomic indicator commit; zero log
# ---------------------------------------------------------------------------

class ContinuityHandler(_Handler):
    name = "continuity"
    table_cls = ch.ContinuityTable
    uses_log = False
    to_numpy = staticmethod(convert.table_to_numpy)
    from_numpy = staticmethod(convert.table_from_numpy)

    # symbolic PM layout: [pair rows: indicator | fp | slots] [ext pool]
    # [ext_map] [stash: (meta | slot) entries]
    def _row_bytes(self, cfg) -> int:
        return ch.INDICATOR_BYTES + ch.FP_BYTES + cfg.slots_per_pair * SLOT_BYTES

    def _addr_indicator(self, cfg, pair) -> int:
        return pair * self._row_bytes(cfg)

    def _addr_fp(self, cfg, pair, lane) -> int:
        return pair * self._row_bytes(cfg) + ch.INDICATOR_BYTES + lane * 4

    def _addr_ext(self, cfg, eidx, eslot) -> int:
        ext_base = cfg.num_pairs * self._row_bytes(cfg)
        return ext_base + (eidx * cfg.ext_slots + eslot) * SLOT_BYTES

    def _addr_map(self, cfg, pair) -> int:
        return (cfg.num_pairs * self._row_bytes(cfg)
                + cfg.ext_pool_pairs * cfg.ext_slots * SLOT_BYTES + pair * 4)

    def _addr_stash(self, cfg, sidx) -> int:
        base = (cfg.num_pairs * self._row_bytes(cfg)
                + cfg.ext_pool_pairs * cfg.ext_slots * SLOT_BYTES
                + cfg.num_pairs * 4)
        return base + sidx * (ch.STASH_META_BYTES + SLOT_BYTES)

    def route(self, cfg, keys, device):
        """``(pair, parity, fingerprint)`` per key."""
        words = _words_on(keys, device)
        pair, parity = ch.locate(cfg, words)
        return (pair.cpu().numpy(), parity.cpu().numpy(),
                ch.fingerprint(words).cpu().numpy())

    def wave_ranks(self, cfg, keys, active, device):
        """Intra-pair cohort ranks — the engine's wave schedule."""
        _, _, rank, _ = ch._plan_waves(
            cfg, _words_on(keys, device),
            torch.from_numpy(np.asarray(active, bool)).to(device))
        return rank.cpu().numpy()

    # -- numpy probe (twin of ch._gather_candidates, one key) ---------------
    def _probe(self, cfg, st, pair, parity, ext_allowed):
        cand = np.asarray(ch._probe_order(cfg))[parity]        # (C,)
        S = cfg.slots_per_pair
        is_ext = cand >= S
        ind = int(st["indicator"][pair])
        bits = (ind >> cand.astype(np.int64)) & 1
        eidx = int(st["ext_map"][pair])
        has_ext = eidx >= 0
        slot_ok = np.where(is_ext, has_ext or ext_allowed, True).astype(bool)
        valid = ((bits == 1) & slot_ok
                 & np.where(is_ext, has_ext, True).astype(bool))
        return cand, valid, slot_ok, has_ext, eidx

    def _cand_keys(self, cfg, st, pair, cand, eidx):
        S = cfg.slots_per_pair
        out = np.zeros((len(cand), KL), U32)
        for j, c in enumerate(cand):
            if c >= S:
                if eidx >= 0:
                    out[j] = st["ext_keys"][eidx, c - S]
            else:
                out[j] = st["keys"][pair, c]
        return out

    def _payload(self, cfg, op_id, pair, slot, eidx, key, val) -> PMStore:
        S = cfg.slots_per_pair
        if slot < S:
            writes = (SubWrite("keys", (pair, slot), key),
                      SubWrite("vals", (pair, slot), val))
            addr = (pair * self._row_bytes(cfg) + ch.INDICATOR_BYTES
                    + ch.FP_BYTES + slot * SLOT_BYTES)
        else:
            writes = (SubWrite("ext_keys", (eidx, slot - S), key),
                      SubWrite("ext_vals", (eidx, slot - S), val))
            addr = self._addr_ext(cfg, eidx, slot - S)
        return PMStore(op_id, "payload", False, addr, SLOT_BYTES, True, writes)

    def _commit(self, cfg, op_id, st, pair, word) -> PMStore:
        # the version bump shares the ONE atomic 8-byte store: the word's
        # upper half is the per-pair committed-op counter (see
        # ch.ContinuityTable.version) — same record, same nbytes, still
        # untearable, zero extra PM writes
        return PMStore(op_id, "indicator", True, self._addr_indicator(cfg, pair),
                       ch.INDICATOR_BYTES, True,
                       (SubWrite("indicator", (pair,), np.uint32(word)),
                        SubWrite("version", (pair,),
                                 U32(int(st["version"][pair]) + 1))))

    def _vbump(self, cfg, op_id, st, pair) -> PMStore:
        """Version-only store of the 8-byte commit word: stash commits live
        OUTSIDE the indicator bits, but cached stamps must still be
        invalidated, so the pair's counter half is bumped on its own."""
        return PMStore(op_id, "vbump", True, self._addr_indicator(cfg, pair),
                       ch.INDICATOR_BYTES, True,
                       (SubWrite("version", (pair,),
                                 U32(int(st["version"][pair]) + 1)),))

    def _fp_rec(self, cfg, op_id, pair, lane, word, kind="fp") -> PMStore:
        """Fingerprint-word lane store: probe metadata only — never the
        visibility commit point, never Table-I-counted."""
        return PMStore(op_id, kind, True, self._addr_fp(cfg, pair, lane), 4,
                       False, (SubWrite("fp", (pair, lane), np.uint32(word)),))

    def _fp_field_word(self, st, pair, slot, fpv) -> Tuple[int, U32]:
        """(lane, new-lane-word) setting ``slot``'s fingerprint field to
        ``fpv`` (the key's fingerprint, from `route`)."""
        lane = slot // ch._FPW
        sh = ch.FP_SLOT_BITS * (slot % ch._FPW)
        old = int(st["fp"][pair, lane])
        return lane, U32((old & ~(ch.FP_MASK << sh)) | (fpv << sh))

    def _smeta(self, cfg, op_id, sidx, value) -> PMStore:
        return PMStore(op_id, "smeta", True, self._addr_stash(cfg, sidx), 8,
                       True, (SubWrite("stash_meta", (sidx,),
                                       np.uint32(value)),))

    def _stash_payload(self, cfg, op_id, sidx, key, val) -> PMStore:
        return PMStore(op_id, "payload", False,
                       self._addr_stash(cfg, sidx) + ch.STASH_META_BYTES,
                       SLOT_BYTES, True,
                       (SubWrite("stash_keys", (sidx,), key),
                        SubWrite("stash_vals", (sidx,), val)))

    def _stash_match(self, cfg, st, pair, key):
        """First live stash entry holding ``key`` homed at ``pair`` (-1)."""
        if not cfg.stash_slots:
            return -1
        m = ((st["stash_meta"] == U32(pair + 1))
             & np.all(st["stash_keys"] == key[None], axis=-1))
        return int(np.argmax(m)) if m.any() else -1

    def _trace_insert(self, cfg, st, op_id, key, val, route,
                      device):
        pair, parity = int(route[0][op_id]), int(route[1][op_id])
        can_alloc = (cfg.ext_frac > 0
                     and int(st["ext_count"]) < cfg.ext_pool_pairs)
        cand, valid, slot_ok, has_ext, eidx = self._probe(
            cfg, st, pair, parity, can_alloc)
        empty = ~valid & slot_ok
        if not empty.any():
            # stash fallback: count-byte bump (conservative overcount is
            # harmless: an extra read, never a missed item) -> payload ->
            # version bump -> atomic meta-word commit.  3 counted writes.
            if not cfg.stash_slots:
                return [], False, "full"
            free = st["stash_meta"][:cfg.stash_slots] == 0
            if not free.any():
                return [], False, "full"
            sidx = int(np.argmax(free))
            cnt = U32(int(st["fp"][pair, 1]) + (1 << ch.STASH_CNT_SHIFT))
            recs = [self._fp_rec(cfg, op_id, pair, 1, cnt),
                    self._stash_payload(cfg, op_id, sidx, key, val),
                    self._vbump(cfg, op_id, st, pair),
                    self._smeta(cfg, op_id, sidx, pair + 1)]
            return recs, True, "stash"
        slot = int(cand[int(np.argmax(empty))])
        S = cfg.slots_per_pair
        recs = []
        if slot >= S and not has_ext:
            eidx = int(st["ext_count"])
            # extension-group grant: allocator metadata (pool-row ownership),
            # persisted but not Table-I-counted (amortized in the paper)
            recs.append(PMStore(
                op_id, "meta", True, self._addr_map(cfg, pair), 8, False,
                (SubWrite("ext_map", (pair,), np.int32(eidx)),
                 SubWrite("ext_count", (), np.int32(eidx + 1)))))
        recs.append(self._payload(cfg, op_id, pair, slot, eidx, key, val))
        if slot < S:
            # the NEW slot's fingerprint field lands before the commit, so
            # the fp pre-filter is always correct for visible slots
            lane, word = self._fp_field_word(st, pair, slot,
                                             int(route[2][op_id]))
            recs.append(self._fp_rec(cfg, op_id, pair, lane, word))
        word = U32(int(st["indicator"][pair]) | (1 << slot))
        recs.append(self._commit(cfg, op_id, st, pair, word))
        return recs, True, ("ext" if slot >= S else "main")

    def _trace_update(self, cfg, st, op_id, key, val, route,
                      device):
        pair, parity = int(route[0][op_id]), int(route[1][op_id])
        cand, valid, slot_ok, has_ext, eidx = self._probe(
            cfg, st, pair, parity, False)
        match = valid & np.all(self._cand_keys(cfg, st, pair, cand, eidx)
                               == key[None], axis=-1)
        empty = ~valid & slot_ok
        sidx = -1 if match.any() else self._stash_match(cfg, st, pair, key)
        if not ((match.any() or sidx >= 0) and empty.any()):
            return [], False, "miss"
        new = int(cand[int(np.argmax(empty))])
        S = cfg.slots_per_pair
        recs = [self._payload(cfg, op_id, pair, new, eidx, key, val)]
        fp1 = int(st["fp"][pair, 1])
        if new < S:
            lane, word = self._fp_field_word(st, pair, new,
                                             int(route[2][op_id]))
            recs.append(self._fp_rec(cfg, op_id, pair, lane, word))
            if lane == 1:
                fp1 = int(word)
        if sidx >= 0:
            # stash relocation: the ONE indicator store makes the main copy
            # win by probe priority; meta clear + count decrement follow as
            # shadowed-entry cleanup (count stays >= live at every prefix)
            word = U32(int(st["indicator"][pair]) ^ (1 << new))
            recs.append(self._commit(cfg, op_id, st, pair, word))
            recs.append(self._smeta(cfg, op_id, sidx, 0))
            recs.append(self._fp_rec(
                cfg, op_id, pair, 1,
                U32(fp1 - (1 << ch.STASH_CNT_SHIFT)), kind="fpcnt"))
            return recs, True, "stash-move"
        old = int(cand[int(np.argmax(match))])
        # out-of-place: BOTH bit flips land in the one atomic word store
        word = U32(int(st["indicator"][pair]) ^ ((1 << old) | (1 << new)))
        recs.append(self._commit(cfg, op_id, st, pair, word))
        return recs, True, "oop"

    def _trace_delete(self, cfg, st, op_id, key, val, route,
                      device):
        pair, parity = int(route[0][op_id]), int(route[1][op_id])
        cand, valid, _, _, eidx = self._probe(cfg, st, pair, parity, False)
        match = valid & np.all(self._cand_keys(cfg, st, pair, cand, eidx)
                               == key[None], axis=-1)
        if not match.any():
            sidx = self._stash_match(cfg, st, pair, key)
            if sidx < 0:
                return [], False, "miss"
            # stash delete: version bump -> atomic meta clear (the commit)
            # -> count-byte decrement AFTER the commit, so the count never
            # reads LOW of the live occupancy at any crash prefix
            recs = [self._vbump(cfg, op_id, st, pair),
                    self._smeta(cfg, op_id, sidx, 0),
                    self._fp_rec(
                        cfg, op_id, pair, 1,
                        U32(int(st["fp"][pair, 1])
                            - (1 << ch.STASH_CNT_SHIFT)), kind="fpcnt")]
            return recs, True, "stash"
        slot = int(cand[int(np.argmax(match))])
        word = U32(int(st["indicator"][pair]) & ~(1 << slot))
        return [self._commit(cfg, op_id, st, pair, word)], True, "main"

    def visible(self, cfg, st):
        out = {}
        S, E = cfg.slots_per_pair, cfg.ext_slots
        for p in range(cfg.num_pairs):
            ind = int(st["indicator"][p])
            for s in range(S):
                if ind >> s & 1:
                    out[_key_bytes(st["keys"][p, s])] = \
                        _key_bytes(st["vals"][p, s])
            e = int(st["ext_map"][p])
            if e >= 0:
                for s in range(E):
                    if ind >> (S + s) & 1:
                        out[_key_bytes(st["ext_keys"][e, s])] = \
                            _key_bytes(st["ext_vals"][e, s])
        for i in range(cfg.stash_slots):
            # probe priority main > ext > stash: a stash copy never shadows
            # a committed row copy (mid-relocation crash states rely on it)
            if int(st["stash_meta"][i]) != 0:
                out.setdefault(_key_bytes(st["stash_keys"][i]),
                               _key_bytes(st["stash_vals"][i]))
        return out

    def rebuild_counts(self, cfg, st):
        st = copy_state(st)
        S, E = cfg.slots_per_pair, cfg.ext_slots
        ind = st["indicator"].astype(U32)
        main = int(popcount(ind & U32((1 << S) - 1)).sum())
        mapped = st["ext_map"] >= 0
        ext = 0
        if E:
            ext = int((popcount((ind >> U32(S)) & U32((1 << E) - 1))
                       * mapped).sum())
        stash = 0
        if cfg.stash_slots:
            stash = int((st["stash_meta"][:cfg.stash_slots] != 0).sum())
        st["count"] = np.asarray(main + ext + stash, st["count"].dtype)
        st["ext_count"] = np.asarray(int(mapped.sum()),
                                     st["ext_count"].dtype)
        return st

    def recover(self, cfg, st):
        """Paper §III-C restart (`restart_table`) of a numpy state, on the
        CPU; the state's other fields are kept."""
        table, report = self.restart_table(
            cfg, self.state_to_table(cfg, st, "cpu"))
        st = copy_state(st)
        st.update(self.to_numpy(table))
        return st, report

    def restart_table(self, cfg, table):
        """Paper §III-C restart of a port table on its device
        (`continuity.restart`): a PURE function of the commit words — the
        indicator words plus (stash-enabled geometries only) the stash
        meta words.  A crashed stash relocation can leave a live meta word
        whose entry is shadowed by the committed row copy; recovery clears
        those (bounded by the stash size, the only payload reads it ever
        does) and re-derives the per-pair count bytes.  No log, ever.
        Returns ``(new table, RecoveryReport)``."""
        table, scanned, dups = ch.restart(cfg, table)
        return table, RecoveryReport(
            self.name, commit_words_scanned=cfg.num_pairs + cfg.stash_slots,
            payload_slots_scanned=scanned, duplicates_cleared=dups)


# ---------------------------------------------------------------------------
# dense — split commit on insert/delete; UNPROTECTED in-place update
# ---------------------------------------------------------------------------

class DenseHandler(_Handler):
    name = "dense"
    table_cls = dn.DenseTable
    uses_log = False
    to_numpy = staticmethod(convert.dense_table_to_numpy)
    from_numpy = staticmethod(convert.dense_table_from_numpy)

    def route(self, cfg, keys, device):
        return None

    def _match(self, st, key):
        m = st["live"] & np.all(st["keys"] == key[None], axis=-1)
        return (int(np.argmax(m)) if m.any() else -1)

    def _trace_insert(self, cfg, st, op_id, key, val, route,
                      device):
        free = ~st["live"]
        if not free.any():
            return [], False, "full"
        slot = int(np.argmax(free))
        recs = [
            PMStore(op_id, "payload", False, slot * SLOT_BYTES, SLOT_BYTES,
                    True, (SubWrite("keys", (slot,), key),
                           SubWrite("vals", (slot,), val))),
            PMStore(op_id, "token", True,
                    cfg.capacity * SLOT_BYTES + slot, 1, True,
                    (SubWrite("live", (slot,), np.bool_(True)),)),
        ]
        return recs, True, "plain"

    def _trace_update(self, cfg, st, op_id, key, val, route,
                      device):
        slot = self._match(st, key)
        if slot < 0:
            return [], False, "miss"
        # in-place value store on a LIVE slot: 1 PM write, no out-of-place
        # commit, no log — a crash mid-store leaves a torn VISIBLE value
        # (the matrix's negative control).
        rec = PMStore(op_id, "payload", False,
                      slot * SLOT_BYTES + KL * 4, VL * 4, True,
                      (SubWrite("vals", (slot,), val),))
        return [rec], True, "inplace"

    def _trace_delete(self, cfg, st, op_id, key, val, route,
                      device):
        slot = self._match(st, key)
        if slot < 0:
            return [], False, "miss"
        rec = PMStore(op_id, "token", True, cfg.capacity * SLOT_BYTES + slot,
                      1, True, (SubWrite("live", (slot,), np.bool_(False)),))
        return [rec], True, "plain"

    def visible(self, cfg, st):
        return {_key_bytes(st["keys"][i]): _key_bytes(st["vals"][i])
                for i in range(cfg.capacity) if st["live"][i]}

    def rebuild_counts(self, cfg, st):
        st = copy_state(st)
        st["count"] = np.asarray(int(st["live"].sum()), st["count"].dtype)
        return st

    def recover(self, cfg, st):
        return self.rebuild_counts(cfg, st), RecoveryReport(
            self.name, commit_words_scanned=cfg.capacity)


# ---------------------------------------------------------------------------
# level — token commits; undo log on the in-place update fallback;
#         crash-safe 5-store slot movement + recovery duplicate scan
# ---------------------------------------------------------------------------

# log entry lanes: [status, region, bucket, slot, old_val*4, ...]
LV_REGION, LV_BUCKET, LV_SLOT, LV_OLD = 1, 2, 3, 4


class LevelHandler(_Handler):
    name = "level"
    table_cls = lv.LevelTable
    uses_log = True
    to_numpy = staticmethod(convert.level_table_to_numpy)
    from_numpy = staticmethod(convert.level_table_from_numpy)

    _REGIONS = (("tkeys", "tvals", "ttok"), ("bkeys", "bvals", "btok"))

    def route(self, cfg, keys, device):
        return lv._cand_buckets(cfg, _words_on(keys, device)).cpu().numpy()

    def _addr_bucket(self, cfg, top, bucket, slot=0) -> int:
        base = 0 if top else cfg.num_top * cfg.bucket_bytes
        return base + bucket * cfg.bucket_bytes + slot * SLOT_BYTES

    def _addr_tok(self, cfg, top, bucket) -> int:
        return (self._addr_bucket(cfg, top, bucket)
                + cfg.bucket_slots * SLOT_BYTES)

    def _tok(self, st, top, bucket) -> int:
        return int(st[self._REGIONS[0 if top else 1][2]][bucket])

    def _payload(self, cfg, op_id, top, bucket, slot, key, val) -> PMStore:
        kf, vf, _ = self._REGIONS[0 if top else 1]
        return PMStore(op_id, "payload", False,
                       self._addr_bucket(cfg, top, bucket, slot), SLOT_BYTES,
                       True, (SubWrite(kf, (bucket, slot), key),
                              SubWrite(vf, (bucket, slot), val)))

    def _commit(self, cfg, op_id, top, bucket, tok) -> PMStore:
        tf = self._REGIONS[0 if top else 1][2]
        return PMStore(op_id, "token", True, self._addr_tok(cfg, top, bucket),
                       8, True, (SubWrite(tf, (bucket,), np.uint8(tok)),))

    def _lookup(self, cfg, st, key, cand):
        """(found, cand_pos, bucket, slot) in the scheme's probe order."""
        bs = cfg.bucket_slots
        for j in range(4):
            top = j < 2
            b = int(cand[j])
            kf = self._REGIONS[0 if top else 1][0]
            tok = self._tok(st, top, b)
            for s in range(bs):
                if tok >> s & 1 and (st[kf][b, s] == key).all():
                    return True, j, b, s
        return False, -1, -1, -1

    def _trace_insert(self, cfg, st, op_id, key, val, route,
                      device):
        cand = route[op_id]
        bs = cfg.bucket_slots
        for j in range(4):
            top = j < 2
            b = int(cand[j])
            tok = self._tok(st, top, b)
            for s in range(bs):
                if not tok >> s & 1:
                    recs = [self._payload(cfg, op_id, top, b, s, key, val),
                            self._commit(cfg, op_id, top, b, tok | 1 << s)]
                    return recs, True, "plain"
        # one-movement path: top[h1] slot 0 moves to ITS alternate top bucket.
        # Crash-safe 5-store order (copy, commit copy, clear source bit,
        # write new item, commit) — matches lv._insert_one.
        b0 = int(cand[0])
        mkey = st["tkeys"][b0, 0].copy()
        mval = st["tvals"][b0, 0].copy()
        mk = _words_on(mkey[None], device)
        a1 = int(hash128(mk)[0]) % cfg.num_top
        a2 = int(hash128_2(mk)[0]) % cfg.num_top
        alt = a2 if a1 == b0 else a1
        atok = self._tok(st, True, alt)
        free = [s for s in range(bs) if not atok >> s & 1]
        if alt == b0 or not free:
            return [], False, "full"
        aslot = free[0]
        tok0 = self._tok(st, True, b0)
        recs = [
            self._payload(cfg, op_id, True, alt, aslot, mkey, mval),
            self._commit(cfg, op_id, True, alt, atok | 1 << aslot),
            self._commit(cfg, op_id, True, b0, tok0 & ~1),
            self._payload(cfg, op_id, True, b0, 0, key, val),
            self._commit(cfg, op_id, True, b0, (tok0 & ~1) | 1),
        ]
        return recs, True, "move"

    def _trace_update(self, cfg, st, op_id, key, val, route,
                      device):
        cand = route[op_id]
        found, j, b, slot = self._lookup(cfg, st, key, cand)
        if not found:
            return [], False, "miss"
        top = j < 2
        bs = cfg.bucket_slots
        tok = self._tok(st, top, b)
        free = [s for s in range(bs) if not tok >> s & 1]
        if free:
            # log-free out-of-place within the same bucket (2 PM writes)
            es = free[0]
            recs = [self._payload(cfg, op_id, top, b, es, key, val),
                    self._commit(cfg, op_id, top, b,
                                 tok ^ ((1 << es) | (1 << slot)))]
            return recs, True, "oop"
        # bucket full -> logged in-place update (4 PM writes):
        # undo entry, atomic commit, in-place item store, invalidate
        vf = self._REGIONS[0 if top else 1][1]
        row = op_id % LOG_ROWS
        lanes = np.zeros((LOG_LANES,), U32)
        lanes[LV_REGION] = 0 if top else 1
        lanes[LV_BUCKET] = b
        lanes[LV_SLOT] = slot
        lanes[LV_OLD:LV_OLD + VL] = st[vf][b, slot]
        recs = [
            self._log_entry(op_id, row, lanes, LV_OLD + VL),
            self._log_status(op_id, row, L_COMMITTED, "log_commit"),
            PMStore(op_id, "payload", False,
                    self._addr_bucket(cfg, top, b, slot) + KL * 4, VL * 4,
                    True, (SubWrite(vf, (b, slot), val),)),
            self._log_status(op_id, row, L_FREE, "log_free"),
        ]
        return recs, True, "logged"

    def _trace_delete(self, cfg, st, op_id, key, val, route,
                      device):
        cand = route[op_id]
        found, j, b, slot = self._lookup(cfg, st, key, cand)
        if not found:
            return [], False, "miss"
        top = j < 2
        tok = self._tok(st, top, b)
        return [self._commit(cfg, op_id, top, b, tok & ~(1 << slot))], \
            True, "plain"

    def visible(self, cfg, st):
        out = {}
        for top, n in ((True, cfg.num_top), (False, cfg.num_bottom)):
            kf, vf, _ = self._REGIONS[0 if top else 1]
            for b in range(n):
                tok = self._tok(st, top, b)
                for s in range(cfg.bucket_slots):
                    if tok >> s & 1:
                        out.setdefault(_key_bytes(st[kf][b, s]),
                                       _key_bytes(st[vf][b, s]))
        return out

    def recover(self, cfg, st):
        """Token scan + undo-log rollback + duplicate scan.

        Rollback first: any COMMITTED undo entry means an in-place update
        may have torn — restore the old value image and free the entry.
        Then a full-table duplicate-key scan repairs interrupted movements
        (the moved item can be committed in two buckets; either copy is
        the same (key, value), keep the probe-order-first one).
        """
        st = copy_state(st)
        rep = RecoveryReport(self.name,
                             commit_words_scanned=cfg.num_top + cfg.num_bottom,
                             log_records_scanned=LOG_ROWS)
        for row in range(LOG_ROWS):
            if int(st[LOG][row, 0]) != L_COMMITTED:
                continue
            top = int(st[LOG][row, LV_REGION]) == 0
            b = int(st[LOG][row, LV_BUCKET])
            s = int(st[LOG][row, LV_SLOT])
            vf = self._REGIONS[0 if top else 1][1]
            st[vf][b, s] = st[LOG][row, LV_OLD:LV_OLD + VL]
            st[LOG][row, 0] = L_FREE
            rep.log_records_used += 1
            rep.repairs += 1
        # duplicate scan (reads payload keys of every live slot)
        seen: Dict[bytes, Tuple] = {}
        for top, n in ((True, cfg.num_top), (False, cfg.num_bottom)):
            kf, _, tf = self._REGIONS[0 if top else 1]
            for b in range(n):
                tok = self._tok(st, top, b)
                for s in range(cfg.bucket_slots):
                    if not tok >> s & 1:
                        continue
                    rep.payload_slots_scanned += 1
                    kb = _key_bytes(st[kf][b, s])
                    if kb in seen:
                        st[tf][b] = np.uint8(self._tok(st, top, b)
                                             & ~(1 << s))
                        rep.duplicates_cleared += 1
                        rep.repairs += 1
                    else:
                        seen[kb] = (top, b, s)
        st = self.rebuild_counts(cfg, st)
        return st, rep

    def rebuild_counts(self, cfg, st):
        st = copy_state(st)
        total = int(popcount(st["ttok"]).sum() + popcount(st["btok"]).sum())
        st["count"] = np.asarray(total, st["count"].dtype)
        return st


# ---------------------------------------------------------------------------
# pfarm — RECIPE redo logging: log entry, commit, stores, invalidate
# ---------------------------------------------------------------------------

# log entry lanes: header [status, kind, ntargets, fresh, home, blk,
# prev_head, pad], then per target: [region, bucket, slot, tok_after,
# key*4, val*4] (12 lanes; up to 2 targets for the displacement path)
PF_KIND, PF_NT, PF_FRESH, PF_HOME, PF_BLK, PF_PREV = 1, 2, 3, 4, 5, 6
PF_T0 = 8
PF_TLANES = 12
K_INS, K_UPD, K_DEL = 1, 2, 3


class PFarmHandler(_Handler):
    name = "pfarm"
    table_cls = pf.PFarmTable
    uses_log = True
    to_numpy = staticmethod(convert.pfarm_table_to_numpy)
    from_numpy = staticmethod(convert.pfarm_table_from_numpy)

    def route(self, cfg, keys, device):
        return pf._home(cfg, _words_on(keys, device)).cpu().numpy()

    def _addr_bucket(self, cfg, region, b, slot=0) -> int:
        base = 0 if region == 0 else cfg.num_buckets * cfg.block_bytes
        return base + b * cfg.block_bytes + slot * SLOT_BYTES

    def _fields(self, region):
        return (("keys", "vals", "tok") if region == 0
                else ("okeys", "ovals", "otok"))

    def _target_lanes(self, region, b, slot, tok_after, key, val):
        lanes = np.zeros((PF_TLANES,), U32)
        lanes[0], lanes[1], lanes[2], lanes[3] = region, b, slot, tok_after
        lanes[4:4 + KL] = key
        lanes[4 + KL:4 + KL + VL] = val
        return lanes

    def _entry(self, op_id, row, kind, targets, fresh=0, home=0, blk=0,
               prev=0) -> PMStore:
        lanes = np.zeros((LOG_LANES,), U32)
        lanes[PF_KIND], lanes[PF_NT] = kind, len(targets)
        lanes[PF_FRESH], lanes[PF_HOME] = fresh, home
        lanes[PF_BLK], lanes[PF_PREV] = blk, U32(prev)
        for i, t in enumerate(targets):
            lanes[PF_T0 + i * PF_TLANES:PF_T0 + (i + 1) * PF_TLANES] = t
        return self._log_entry(op_id, row, lanes,
                               PF_T0 + len(targets) * PF_TLANES)

    def _store_target(self, cfg, op_id, region, b, slot, tok_after, key, val,
                      scrub=False):
        """The (payload, token) store pair a logged target performs."""
        kf, vf, tf = self._fields(region)
        return [
            PMStore(op_id, "payload", False,
                    self._addr_bucket(cfg, region, b, slot), SLOT_BYTES, True,
                    (SubWrite(kf, (b, slot), key),
                     SubWrite(vf, (b, slot), val))),
            PMStore(op_id, "token", True,
                    self._addr_bucket(cfg, region, b)
                    + cfg.bucket_slots * SLOT_BYTES, 8, True,
                    (SubWrite(tf, (b,), np.uint8(tok_after)),)),
        ]

    def _trace_insert(self, cfg, st, op_id, key, val, route,
                      device):
        home = int(route[op_id])
        bs, H, N = cfg.bucket_slots, cfg.window, cfg.num_buckets
        win = [(home + j) % N for j in range(H)]
        row = op_id % LOG_ROWS
        for b in win:
            tok = int(st["tok"][b])
            for s in range(bs):
                if not tok >> s & 1:
                    t = self._target_lanes(0, b, s, tok | 1 << s, key, val)
                    recs = [self._entry(op_id, row, K_INS, [t]),
                            self._log_status(op_id, row, L_COMMITTED,
                                             "log_commit")]
                    recs += self._store_target(cfg, op_id, 0, b, s,
                                               tok | 1 << s, key, val)
                    recs.append(self._log_status(op_id, row, L_FREE,
                                                 "log_free"))
                    return recs, True, "plain"
        # window full: ONE displacement attempt (a window item that can move
        # to a free slot in ITS OWN window), else chain an overflow block
        move = self._find_move(cfg, st, win, device)
        if move is not None:
            (sb, ss), (db, ds) = move
            mkey = st["keys"][sb, ss].copy()
            mval = st["vals"][sb, ss].copy()
            dtok = int(st["tok"][db]) | 1 << ds
            stok_clear = int(st["tok"][sb]) & ~(1 << ss)
            t0 = self._target_lanes(0, db, ds, dtok, mkey, mval)
            t1 = self._target_lanes(0, sb, ss, stok_clear | 1 << ss, key, val)
            recs = [self._entry(op_id, row, K_INS, [t0, t1]),
                    self._log_status(op_id, row, L_COMMITTED, "log_commit")]
            recs += self._store_target(cfg, op_id, 0, db, ds, dtok, mkey, mval)
            recs.append(PMStore(
                op_id, "token", True,
                self._addr_bucket(cfg, 0, sb) + bs * SLOT_BYTES, 8, True,
                (SubWrite("tok", (sb,), np.uint8(stok_clear)),)))
            recs += self._store_target(cfg, op_id, 0, sb, ss,
                                       stok_clear | 1 << ss, key, val)
            recs.append(self._log_status(op_id, row, L_FREE, "log_free"))
            return recs, True, "displace"
        # chain: append to the head block if it has space, else allocate
        head = int(st["head"][home])
        if head >= 0:
            htok = int(st["otok"][head])
            free = [s for s in range(bs) if not htok >> s & 1]
            if free:
                s = free[0]
                t = self._target_lanes(1, head, s, htok | 1 << s, key, val)
                recs = [self._entry(op_id, row, K_INS, [t]),
                        self._log_status(op_id, row, L_COMMITTED,
                                         "log_commit")]
                recs += self._store_target(cfg, op_id, 1, head, s,
                                           htok | 1 << s, key, val)
                recs.append(self._log_status(op_id, row, L_FREE, "log_free"))
                return recs, True, "chain"
        if int(st["ocount"]) >= cfg.pool_blocks:
            return [], False, "full"
        blk = int(st["ocount"])
        t = self._target_lanes(1, blk, 0, 1, key, val)
        recs = [self._entry(op_id, row, K_INS, [t], fresh=1, home=home,
                            blk=blk, prev=head),
                self._log_status(op_id, row, L_COMMITTED, "log_commit")]
        recs += self._store_target(cfg, op_id, 1, blk, 0, 1, key, val)
        # chain pointers: persistent metadata, re-derived from the log on
        # recovery; RECIPE folds them into its flat 5-write cost
        recs.append(PMStore(
            op_id, "meta", True, 1 << 29 | blk * 8, 8, False,
            (SubWrite("onext", (blk,), np.int32(head)),
             SubWrite("head", (home,), np.int32(blk)),
             SubWrite("ocount", (), np.int32(blk + 1)))))
        recs.append(self._log_status(op_id, row, L_FREE, "log_free"))
        return recs, True, "chain"

    def _find_move(self, cfg, st, win, device):
        """Twin of pf displacement: first window slot whose item can move to
        a free slot of ITS OWN window; returns ((src_b, src_s), (dst_b,
        dst_s)) or None."""
        bs, H, N = cfg.bucket_slots, cfg.window, cfg.num_buckets
        wkeys = np.stack([st["keys"][b] for b in win]).reshape(H * bs, KL)
        whome = pf._home(cfg, _words_on(wkeys, device)).cpu().numpy()
        for m in range(H * bs):
            mwin = [(int(whome[m]) + j) % N for j in range(H)]
            for db in mwin:
                tok = int(st["tok"][db])
                for s in range(bs):
                    if not tok >> s & 1:
                        return (win[m // bs], m % bs), (db, s)
        return None

    def _lookup(self, cfg, st, key, home):
        bs, H, N = cfg.bucket_slots, cfg.window, cfg.num_buckets
        for j in range(H):
            b = (home + j) % N
            tok = int(st["tok"][b])
            for s in range(bs):
                if tok >> s & 1 and (st["keys"][b, s] == key).all():
                    return 0, b, s
        cur, hops = int(st["head"][home]), 0
        while cur >= 0 and hops < cfg.max_chain:
            tok = int(st["otok"][cur])
            for s in range(bs):
                if tok >> s & 1 and (st["okeys"][cur, s] == key).all():
                    return 1, cur, s
            cur, hops = int(st["onext"][cur]), hops + 1
        return -1, -1, -1

    def _trace_update(self, cfg, st, op_id, key, val, route,
                      device):
        region, b, slot = self._lookup(cfg, st, key, int(route[op_id]))
        if region < 0:
            return [], False, "miss"
        kf, vf, tf = self._fields(region)
        tok = int(st[tf][b])
        row = op_id % LOG_ROWS
        t = self._target_lanes(region, b, slot, tok, key, val)
        recs = [self._entry(op_id, row, K_UPD, [t]),
                self._log_status(op_id, row, L_COMMITTED, "log_commit"),
                # logged in-place value store (the undo/redo log is what
                # makes this multi-byte overwrite of a LIVE slot safe)
                PMStore(op_id, "payload", False,
                        self._addr_bucket(cfg, region, b, slot) + KL * 4,
                        VL * 4, True, (SubWrite(vf, (b, slot), val),)),
                PMStore(op_id, "token", True,
                        self._addr_bucket(cfg, region, b)
                        + cfg.bucket_slots * SLOT_BYTES, 8, True,
                        (SubWrite(tf, (b,), np.uint8(tok)),)),
                self._log_status(op_id, row, L_FREE, "log_free")]
        return recs, True, "logged"

    def _trace_delete(self, cfg, st, op_id, key, val, route,
                      device):
        region, b, slot = self._lookup(cfg, st, key, int(route[op_id]))
        if region < 0:
            return [], False, "miss"
        kf, vf, tf = self._fields(region)
        tok = int(st[tf][b]) & ~(1 << slot)
        row = op_id % LOG_ROWS
        zero = np.zeros((KL,), U32)
        t = self._target_lanes(region, b, slot, tok, zero, zero)
        recs = [self._entry(op_id, row, K_DEL, [t]),
                self._log_status(op_id, row, L_COMMITTED, "log_commit"),
                PMStore(op_id, "payload", False,
                        self._addr_bucket(cfg, region, b, slot), SLOT_BYTES,
                        True, (SubWrite(kf, (b, slot), zero),
                               SubWrite(vf, (b, slot), zero))),
                PMStore(op_id, "token", True,
                        self._addr_bucket(cfg, region, b)
                        + cfg.bucket_slots * SLOT_BYTES, 8, True,
                        (SubWrite(tf, (b,), np.uint8(tok)),)),
                self._log_status(op_id, row, L_FREE, "log_free")]
        return recs, True, "logged"

    def visible(self, cfg, st):
        out = {}
        for b in range(cfg.num_buckets):
            tok = int(st["tok"][b])
            for s in range(cfg.bucket_slots):
                if tok >> s & 1:
                    out.setdefault(_key_bytes(st["keys"][b, s]),
                                   _key_bytes(st["vals"][b, s]))
        for b in range(cfg.pool_blocks):
            tok = int(st["otok"][b])
            for s in range(cfg.bucket_slots):
                if tok >> s & 1:
                    out.setdefault(_key_bytes(st["okeys"][b, s]),
                                   _key_bytes(st["ovals"][b, s]))
        return out

    def recover(self, cfg, st):
        """RECIPE restart: FULL redo-log replay — every committed,
        non-invalidated entry is reapplied against the table (item stores,
        token stores, chain pointers), then freed."""
        st = copy_state(st)
        rep = RecoveryReport(
            self.name,
            commit_words_scanned=cfg.num_buckets + cfg.pool_blocks,
            log_records_scanned=LOG_ROWS)
        for row in range(LOG_ROWS):
            if int(st[LOG][row, 0]) != L_COMMITTED:
                continue
            lanes = st[LOG][row]
            for i in range(int(lanes[PF_NT])):
                t = lanes[PF_T0 + i * PF_TLANES:PF_T0 + (i + 1) * PF_TLANES]
                region, b, slot, tok = (int(t[0]), int(t[1]), int(t[2]),
                                        int(t[3]))
                kf, vf, tf = self._fields(region)
                st[kf][b, slot] = t[4:4 + KL]
                st[vf][b, slot] = t[4 + KL:4 + KL + VL]
                st[tf][b] = np.uint8(tok)
                rep.repairs += 3
            if int(lanes[PF_FRESH]):
                blk, home = int(lanes[PF_BLK]), int(lanes[PF_HOME])
                st["onext"][blk] = np.int32(lanes[PF_PREV])
                st["head"][home] = blk
                rep.repairs += 2
            st[LOG][row, 0] = L_FREE
            rep.log_records_used += 1
        st = self.rebuild_counts(cfg, st)
        return st, rep

    def rebuild_counts(self, cfg, st):
        """Allocator metadata from the chain pointers + token popcounts."""
        st = copy_state(st)
        refs = set()
        for h in range(cfg.num_buckets):
            cur, hops = int(st["head"][h]), 0
            while cur >= 0 and hops <= cfg.pool_blocks:
                refs.add(cur)
                cur, hops = int(st["onext"][cur]), hops + 1
        st["ocount"] = np.asarray(len(refs), st["ocount"].dtype)
        total = int(popcount(st["tok"]).sum() + popcount(st["otok"]).sum())
        st["count"] = np.asarray(total, st["count"].dtype)
        return st


HANDLERS: Dict[str, _Handler] = {h.name: h for h in (
    ContinuityHandler(), DenseHandler(), LevelHandler(), PFarmHandler())}


# ---------------------------------------------------------------------------
# batch tracing
# ---------------------------------------------------------------------------

def trace_batch(handler: _Handler, cfg, table_or_state, op: str,
                keys, vals=None, mask=None, order: str = "serial", *,
                device) -> Tuple[State, PMTrace]:
    """Trace a batch op: returns the fully-applied final state + the trace.
    Routing runs on ``device``, the store's (``"cuda"`` or ``"cpu"``; it
    has no default, so a caller cannot route on the host by omission).

    ``order="serial"`` emits records in batch order (the `lax.scan`
    reference schedule).  ``order="wave"`` (continuity only) reorders
    records into the wave engine's schedule — per wave, all payload
    stores then all one-word commits; per-pair commit order is still
    batch order, so the durable final state is identical (asserted by
    tests/test_torch_crash_consistency.py).
    """
    keys = host_words(keys, KL)
    B = keys.shape[0]
    if vals is not None:
        vals = host_words(vals, VL)
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    active = (np.ones((B,), bool) if mask is None
              else np.asarray(mask).reshape(B).astype(bool))
    state = handler.init_state(cfg, table_or_state)
    route = handler.route(cfg, keys, device)
    records: List[PMStore] = []
    ops_meta: List[TraceOp] = []
    for i in range(B):
        if not active[i]:
            ops_meta.append(TraceOp(i, op, False, "masked", keys[i].tobytes(),
                                    None if vals is None
                                    else vals[i].tobytes()))
            continue
        recs, ok, path = handler.trace_one(
            cfg, state, op, i, keys[i],
            None if vals is None else vals[i], route, device)
        for r in recs:
            apply_store(state, r)
        records.extend(recs)
        ops_meta.append(TraceOp(i, op, ok, path, keys[i].tobytes(),
                                None if vals is None else vals[i].tobytes()))
    if order == "wave":
        assert hasattr(handler, "wave_ranks"), \
            f"{handler.name} has no wave schedule"
        rank = handler.wave_ranks(cfg, keys, active, device)
        phase = {"vbump": 1, "indicator": 1, "token": 1,
                 "smeta": 2, "fpcnt": 3}
        records = [r for _, r in sorted(
            enumerate(records),
            key=lambda ir: (int(rank[ir[1].op_id]),
                            phase.get(ir[1].kind, 0), ir[1].op_id, ir[0]))]
    return state, PMTrace(handler.name, op, records, ops_meta, order)
