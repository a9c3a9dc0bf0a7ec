"""Plain reference of the store's semantics: a map from 16-byte keys to
16-byte values, in plain PyTorch.  It imports nothing of the program.

The benchmark's keys are made from record ids (``ycsb.make_key``), so the
map is direct-addressed: a key is present when it decodes to an id below
``records``, it equals the key made from that id, and that record is
live.  Operations apply one at a time in batch order: a lookup returns
the live value or misses, an acknowledged update of a live key replaces
its value (within one batch the last acknowledged update of a key wins),
a refused update changes nothing.
"""

from __future__ import annotations

import torch

from portbench import ycsb


class KVMap:
    def __init__(self, records: int, values: torch.Tensor,
                 live: torch.Tensor):
        self.records = records
        self.values = values.clone()
        self.live = live.clone()

    def _ids(self, keys):
        ids = ycsb.key_ids(keys)
        inside = ids < self.records
        at = torch.where(inside, ids, 0)
        exact = inside & (ycsb.make_key(at) == keys).all(-1)
        return at, exact & self.live[at]

    def lookup(self, keys):
        """(found (B,), values (B, 4)): zeros where a key misses."""
        at, found = self._ids(keys)
        return found, torch.where(found[:, None], self.values[at], 0)

    def update(self, keys, values, acked):
        """Apply the acknowledged updates of one batch; returns how many
        were acknowledged for keys that are not live (each a fault)."""
        at, found = self._ids(keys)
        bad = int((acked & ~found).sum())
        sel = (acked & found).nonzero().squeeze(1)
        if sel.numel():
            ids = at[sel]
            order = torch.argsort(ids * (len(keys) + 1) + sel)
            ids, sel = ids[order], sel[order]
            last = torch.ones_like(ids, dtype=torch.bool)
            last[:-1] = ids[:-1] != ids[1:]
            self.values[ids[last]] = values[sel[last]]
        return bad
