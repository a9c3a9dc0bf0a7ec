"""Plain PyTorch version of the serial-walk kernel (``scan_walk.py``).

Per-op functions mirroring the reference's ``_insert_one`` /
``_update_one`` / ``_delete_one`` of ``repro.core.level`` and
``repro.core.pfarm`` (and ``routed_write_ref``, continuity's routed
writes of ``repro.core.distributed``), applied to the batch in order, in
place: each op
reads what the previous one left, and takes exactly the branch the
reference's ``lax.cond`` takes.  As the kernel does, the key-only
quantities (level's candidate buckets, pfarm's home bucket) are computed
for the whole batch first, and update/delete find their key by reading
the op's own candidates in the order of the reference's batched lookup
(its first match; the batched lookup itself, once per op, is ~1 ms on
the CPU, too slow for the card tests' batches of 4,096).  Masked-off ops change nothing (every write of
the reference is gated by ``active``) and are skipped.

The CPU path of ``scan_walk.scan_walk`` and the oracle the CUDA kernel is
held against on the card; nothing on the card's path calls it.
"""

from __future__ import annotations

import torch

from repro_torch.core.hashfn import hash128, hash128_2

I32 = torch.int32


def _first_empty(tok: int, bs: int) -> int:
    """Index of the first clear bit of ``tok`` below ``bs``; -1 if none."""
    for s in range(bs):
        if not (tok >> s) & 1:
            return s
    return -1


# -- level ------------------------------------------------------------------

def _level_arrays(t, j: int):
    """(keys, vals, tok) arrays of candidate ``j`` (0, 1 top; 2, 3 bottom)."""
    return (t.tkeys, t.tvals, t.ttok) if j < 2 else (t.bkeys, t.bvals, t.btok)


def _level_insert_one(cfg, t, key, val, cand):
    bs = cfg.bucket_slots
    for j in range(4):
        keys, vals, tok = _level_arrays(t, j)
        tk = int(tok[cand[j]])
        s = _first_empty(tk, bs)
        if s >= 0:                       # plain path: slot, then token
            keys[cand[j], s] = key
            vals[cand[j], s] = val
            tok[cand[j]] = tk | (1 << s)
            return True, 2
    # one-movement path: top[h1]'s slot-0 item moves to its alternate top
    # bucket if that has space (copy, commit, clear source bit, write the
    # new item into the freed slot, commit)
    c0 = cand[0]
    mkey, mval = t.tkeys[c0, 0].clone(), t.tvals[c0, 0].clone()
    a1 = int(hash128(mkey[None])[0]) % cfg.num_top
    a2 = int(hash128_2(mkey[None])[0]) % cfg.num_top
    alt = a2 if a1 == c0 else a1
    atok = int(t.ttok[alt])
    aslot = _first_empty(atok, bs)
    if aslot < 0 or alt == c0:
        return False, 0
    t.tkeys[alt, aslot] = mkey
    t.tvals[alt, aslot] = mval
    t.ttok[alt] = atok | (1 << aslot)
    src = int(t.ttok[c0]) & 0xFE
    t.ttok[c0] = src
    t.tkeys[c0, 0] = key
    t.tvals[c0, 0] = val
    t.ttok[c0] = src | 1
    return True, 5


def _level_where(cfg, t, key, cand):
    """What the reference's batched lookup finds for one key: (bucket#,
    slot) of the first match over [t1, t2, b1, b2] x slots, or None."""
    for j in range(4):
        keys, _, tok = _level_arrays(t, j)
        tk = int(tok[cand[j]])
        if tk:
            eq = (keys[cand[j]] == key).all(-1).tolist()
            for s in range(cfg.bucket_slots):
                if (tk >> s) & 1 and eq[s]:
                    return j, s
    return None


def _level_delete_one(cfg, t, key, cand):
    w = _level_where(cfg, t, key, cand)
    if w is None:
        return False, 0
    j, s = w
    _, _, tok = _level_arrays(t, j)
    tok[cand[j]] = int(tok[cand[j]]) & ~(1 << s) & 0xFF
    return True, 1


def _level_update_one(cfg, t, key, val, cand):
    w = _level_where(cfg, t, key, cand)
    if w is None:
        return False, 0
    j, s = w
    keys, vals, tok = _level_arrays(t, j)
    b = cand[j]
    tk = int(tok[b])
    e = _first_empty(tk, cfg.bucket_slots)
    if e >= 0:             # log-free out of place in the same bucket
        keys[b, e] = key
        vals[b, e] = val
        tok[b] = tk ^ ((1 << e) | (1 << s))
        return True, 2
    keys[b, s] = key       # logged in place (log, item, commit, invalidate)
    vals[b, s] = val
    return True, 4


# -- pfarm ------------------------------------------------------------------

def _pfarm_insert_one(cfg, t, key, val, home):
    bs, H, N = cfg.bucket_slots, cfg.window, cfg.num_buckets
    win = [(home + j) % N for j in range(H)]
    for b in win:
        tk = int(t.tok[b])
        s = _first_empty(tk, bs)
        if s >= 0:                       # plain path
            t.keys[b, s] = key
            t.vals[b, s] = val
            t.tok[b] = tk | (1 << s)
            return True
    # ONE displacement: the first window item (bucket-major, slot-minor)
    # with a free slot in its own window moves there
    wkeys = t.keys[win].reshape(H * bs, -1)
    wwin = ((hash128(wkeys) % N)[:, None]
            + torch.arange(H, device=wkeys.device)) % N
    wtok = t.tok[wwin].tolist()                       # (H*bs, H)
    wwin = wwin.tolist()
    for i in range(H * bs):
        for j in range(H):
            db = wwin[i][j]
            ds = _first_empty(wtok[i][j], bs)
            if ds >= 0:
                sb, ss = win[i // bs], i % bs
                t.keys[db, ds] = t.keys[sb, ss]
                t.vals[db, ds] = t.vals[sb, ss]
                t.tok[db] = int(t.tok[db]) | (1 << ds)
                t.tok[sb] = int(t.tok[sb]) & ~(1 << ss) & 0xFF
                t.keys[sb, ss] = key
                t.vals[sb, ss] = val
                t.tok[sb] = int(t.tok[sb]) | (1 << ss)
                return True
    # chain: append to the head block if it has space, else a fresh block
    head = int(t.head[home])
    hslot = _first_empty(int(t.otok[head]), bs) if head >= 0 else -1
    ocount = int(t.ocount)
    if hslot >= 0:
        blk, slot = head, hslot
    elif ocount < cfg.pool_blocks:
        blk, slot = ocount, 0
    else:
        return False                     # pool full
    t.okeys[blk, slot] = key
    t.ovals[blk, slot] = val
    t.otok[blk] = int(t.otok[blk]) | (1 << slot)
    if hslot < 0:
        t.onext[blk] = head
        t.head[home] = blk
        t.ocount.add_(1)
    return True


def _pfarm_where(cfg, t, key, home):
    """What the reference's batched lookup finds for one key: (in_chain,
    bucket or block, slot) of the first window match (bucket-major), else
    of the first chain block holding it within ``max_chain`` hops; or
    None."""
    bs, N = cfg.bucket_slots, cfg.num_buckets
    win = [(home + j) % N for j in range(cfg.window)]
    toks = t.tok[win].tolist()
    eq = (t.keys[win] == key).all(-1).tolist()
    for j, b in enumerate(win):
        for s in range(bs):
            if (toks[j] >> s) & 1 and eq[j][s]:
                return 0, b, s
    cur = int(t.head[home])
    for _ in range(cfg.max_chain):
        if cur < 0:
            break
        tk = int(t.otok[cur])
        eq = (t.okeys[cur] == key).all(-1).tolist()
        for s in range(bs):
            if (tk >> s) & 1 and eq[s]:
                return 1, cur, s
        cur = int(t.onext[cur])
    return None


def _pfarm_delete_one(cfg, t, key, home):
    w = _pfarm_where(cfg, t, key, home)
    if w is None:
        return False
    in_chain, b, s = w
    tok = t.otok if in_chain else t.tok
    tok[b] = int(tok[b]) & ~(1 << s) & 0xFF
    return True


def _pfarm_update_one(cfg, t, key, val, home):
    w = _pfarm_where(cfg, t, key, home)
    if w is None:
        return False
    in_chain, b, s = w
    (t.ovals if in_chain else t.vals)[b, s] = val
    return True


# -- the walk ---------------------------------------------------------------

def scan_walk_ref(scheme: str, op: str, cfg, t, keys, vals, active):
    """Apply the batch in order to table ``t`` in place; returns ``(ok,
    pm)``, each (B,) int32 (``pm`` the PM writes each op charged)."""
    from repro_torch.core import level as lv
    from repro_torch.core import pfarm as pf
    B = keys.shape[0]
    ok = torch.zeros(B, dtype=I32, device=keys.device)
    pm = torch.zeros(B, dtype=I32, device=keys.device)
    if scheme == "level":
        cand = lv._cand_buckets(cfg, keys).tolist()
    else:
        cand = pf._home(cfg, keys).tolist()
    act = active.tolist()
    for i in range(B):
        if not act[i]:
            continue
        if scheme == "level":
            if op == "insert":
                done, w = _level_insert_one(cfg, t, keys[i], vals[i], cand[i])
            elif op == "update":
                done, w = _level_update_one(cfg, t, keys[i], vals[i], cand[i])
            else:
                done, w = _level_delete_one(cfg, t, keys[i], cand[i])
        else:
            if op == "insert":
                done = _pfarm_insert_one(cfg, t, keys[i], vals[i], cand[i])
            elif op == "update":
                done = _pfarm_update_one(cfg, t, keys[i], vals[i], cand[i])
            else:
                done = _pfarm_delete_one(cfg, t, keys[i], cand[i])
            w = pf.PM_WRITES_PER_OP
        if done:
            ok[i] = 1
            pm[i] = w
            if op == "insert":
                t.count.add_(1)
            elif op == "delete":
                t.count.sub_(1)
    return ok, pm


# -- continuity's routed writes -------------------------------------------------

def routed_write_ref(cfg, t, pair, parity, op, keys, vals, live):
    """Plain version of ``scan_walk.routed_write``: the reference's
    ``_apply_routed_writes`` (``src/repro/core/distributed.py:228``), one
    entry at a time in order, on the local ext-free table ``t`` in place.
    An insert takes the first free slot of the key's segment when the key
    is absent; an update needs a match and a free slot (the new slot
    written, then both bits flipped); a delete clears the match's bit.
    Every success commits the indicator word and bumps ``version``; the
    fingerprint word and ``count`` are not written.  Returns the (N,)
    int32 status (1 = applied)."""
    seg, sp = cfg.seg_slots, cfg.slots_per_pair
    N = pair.shape[0]
    status = torch.zeros(N, dtype=I32, device=keys.device)
    pr_l, pa_l, op_l, lv_l = (pair.tolist(), parity.tolist(), op.tolist(),
                              live.tolist())
    for i in range(N):
        o = op_l[i]
        if not lv_l[i] or o not in (1, 2, 3):
            continue
        pr = pr_l[i]
        cand = range(seg) if pa_l[i] == 0 else range(sp - 1, sp - 1 - seg, -1)
        word = int(t.indicator[pr]) & 0xFFFFFFFF
        eq = (t.keys[pr] == keys[i]).all(-1).tolist()
        mslot = next((s for s in cand if (word >> s) & 1 and eq[s]), None)
        eslot = next((s for s in cand if not (word >> s) & 1), None)
        if o == 1:
            done = eslot is not None and mslot is None
        elif o == 2:
            done = mslot is not None and eslot is not None
        else:
            done = mslot is not None
        if not done:
            continue
        if o != 3:
            t.keys[pr, eslot] = keys[i]
            t.vals[pr, eslot] = vals[i]
        if o == 1:
            word |= 1 << eslot
        elif o == 2:
            word = (word | (1 << eslot)) ^ (1 << mslot)
        else:
            word &= ~(1 << mslot) & 0xFFFFFFFF
        t.indicator[pr] = word - (1 << 32) if word >> 31 else word
        v = (int(t.version[pr]) + 1) & 0xFFFFFFFF
        t.version[pr] = v - (1 << 32) if v >> 31 else v
        status[i] = 1
    return status


# -- the latency chase --------------------------------------------------------

def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def chase_ref(data, elem: int, steps: int, seed: int):
    """Plain version of ``scan_walk.chase``: the same chain of dependent
    loads on the host; returns the final state as a (1,) int32 tensor."""
    buf = data.numpy() if data.device.type == "cpu" else data
    n = data.shape[0] // elem
    h = seed & 0xFFFFFFFF
    for i in range(steps):
        b = int(buf[((h * n) >> 32) * elem])
        h = _fmix32(h ^ b ^ ((i * 0x9E3779B9) & 0xFFFFFFFF))
    return torch.tensor([h - (1 << 32) if h >> 31 else h], dtype=torch.int32)
