"""Plain PyTorch version of the mutation-plan kernel (``mutate.py``).

A straight port of ``repro.kernels.mutate_ref``: the same fetch and rank
math as ``probe_ref`` with the fingerprint filter always on, plus the
one-word XOR ``flip`` an uncontended update would commit.
"""

from __future__ import annotations

import torch

from repro_torch.core.words import bit, to_i32, u32
from repro_torch.kernels.probe_ref import rank_select, segment_state, slot_fields


def mutate_ref(rows, indicators, fps, prio, pairs, parity, qkeys, qfp):
    """Returns ``(match_slot, victim_slot, flip)``: (B,) int32, with -1 for
    miss/full and ``flip`` the commit mask as an int32 word."""
    S = rows.shape[1] // qkeys.shape[1]
    eq, bits = segment_state(rows, indicators, pairs, qkeys)
    field = slot_fields(fps[pairs.to(torch.int64)], S)
    eq = eq & (field == u32(qfp)[:, None])
    pr = prio[parity.to(torch.int64)].to(torch.int64)
    match, victim = rank_select(eq, bits, pr)
    m, v = match.to(torch.int64), victim.to(torch.int64)
    flip = (torch.where(m >= 0, bit(m.clamp(min=0)), 0)
            | torch.where(v >= 0, bit(v.clamp(min=0)), 0))
    return match, victim, to_i32(flip)
