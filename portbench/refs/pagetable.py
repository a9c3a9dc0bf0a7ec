"""Plain audit of a paged cache's page table, read from the table's state.

The page table maps (sequence id, logical page) to a physical page.  Its
keys are the four words ``(seq, page, seq ^ page, 0xC0FFEE01)`` and its
values ``(phys, 0, 0, 0)``.  The audit reads the live entries out of the
continuity table's tensors as the paper lays them out (one indicator bit
per main slot of a pair's row, then one per slot of the pair's extension
group; a stash entry is live while its meta word is not 0) and holds them
against the mappings the served requests need: every (sequence, page) of
each live sequence present once, nothing else, and no two mappings on
one physical page of the pool.  It imports nothing of the program.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
PAGE_SALT = 0xC0FFEE01


def live_entries(t) -> tuple:
    """(keys (n, 4), values (n, 4)) int64 words of every live entry of a
    continuity table ``t`` (any object with its tensor fields)."""
    P, S = t.keys.shape[:2]
    E = t.ext_keys.shape[1]
    ind = t.indicator.to(torch.int64) & MASK32
    dev = ind.device
    main = ((ind[:, None] >> torch.arange(S, device=dev)) & 1) == 1
    keys, vals = [t.keys[main]], [t.vals[main]]
    if E:
        ebits = ((ind[:, None] >> (S + torch.arange(E, device=dev))) & 1) == 1
        has = t.ext_map >= 0
        pe, je = (ebits & has[:, None]).nonzero(as_tuple=True)
        g = t.ext_map[pe].long()
        keys.append(t.ext_keys[g, je])
        vals.append(t.ext_vals[g, je])
    st = t.stash_meta != 0
    keys.append(t.stash_keys[st])
    vals.append(t.stash_vals[st])
    return (torch.cat(keys).to(torch.int64) & MASK32,
            torch.cat(vals).to(torch.int64) & MASK32)


def audit(t, seq_ids: torch.Tensor, pages: int, pool_pages: int) -> int:
    """Faults of the page table ``t`` holding the sequences ``seq_ids``
    with ``pages`` logical pages each: mappings missing, mappings extra or
    malformed, and physical pages mapped twice or outside the pool."""
    keys, vals = live_entries(t)
    s = seq_ids.to(torch.int64).reshape(-1) & MASK32
    p = torch.arange(pages, device=s.device)
    want = ((s[:, None] << 32) | p[None, :]).reshape(-1)
    well = (keys[:, 2] == (keys[:, 0] ^ keys[:, 1])) & \
        (keys[:, 3] == PAGE_SALT)
    code = (keys[:, 0] << 32) | keys[:, 1]
    hit = well & torch.isin(code, want)
    missing = int((~torch.isin(want, code[hit])).sum())
    extra = int((~hit).sum()) + (int(hit.sum()) - int(
        torch.unique(code[hit]).numel()))
    phys = vals[hit, 0]
    bad = int(((phys >= pool_pages) | (vals[hit, 1:] != 0).any(-1)).sum())
    doubled = int(phys.numel() - torch.unique(phys).numel())
    return missing + extra + bad + doubled
