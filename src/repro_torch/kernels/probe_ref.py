"""Plain PyTorch version of the segment-probe kernel (``probe.py``).

A straight port of ``repro.kernels.probe_ref``: gather the per-query
segment row and run the directional rank math as one (B, S) pass.  The CPU
path of ``probe.probe_segments`` and the oracle the CUDA kernel is held
against on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.words import u32

BIG = 0x7FFFFFFF


def slot_fields(fps_rows: torch.Tensor, S: int) -> torch.Tensor:
    """(B, S) 2-bit fp field of each slot from (B, 2) fp words: lane
    ``s // 16``, shift ``2 * (s % 16)``."""
    s = torch.arange(S, device=fps_rows.device)
    lane = torch.where(s[None] < 16, u32(fps_rows[:, 0:1]),
                       u32(fps_rows[:, 1:2]))
    return (lane >> (2 * (s % 16))[None]) & 3


def rank_select(eq, bits, pr):
    """(match, empty) argmin-rank slots, -1 when there is none."""
    cand = pr < BIG
    mrank = torch.where(eq & (bits == 1) & cand, pr, BIG)
    erank = torch.where((bits == 0) & cand, pr, BIG)
    match = torch.where(mrank.amin(-1) < BIG, torch.argmin(mrank, -1), -1)
    empty = torch.where(erank.amin(-1) < BIG, torch.argmin(erank, -1), -1)
    return match.to(torch.int32), empty.to(torch.int32)


def segment_state(rows, indicators, pairs, qkeys):
    """(eq, bits) of every slot of each query's segment row."""
    B, KL = qkeys.shape
    S = rows.shape[1] // KL
    pairs = pairs.to(torch.int64)
    seg = rows[pairs].reshape(B, S, KL)
    eq = (seg == qkeys[:, None, :]).all(-1)
    ind = u32(indicators[pairs, 0])
    bits = (ind[:, None] >> torch.arange(S, device=rows.device)[None]) & 1
    return eq, bits


def probe_ref(rows: torch.Tensor, indicators: torch.Tensor,
              prio: torch.Tensor, pairs: torch.Tensor, parity: torch.Tensor,
              qkeys: torch.Tensor, fps: torch.Tensor | None = None,
              qfp: torch.Tensor | None = None):
    """Reference segment probe.

    Args:
      rows:       (P, SLOTS*KL) int32 words — contiguous segment-pair rows
      indicators: (P, 1) int32 words
      prio:       (2, SLOTS) int32 probe rank per parity (BIG = not a candidate)
      pairs:      (B,) home pair per query
      parity:     (B,)
      qkeys:      (B, KL) int32 words
      fps:        optional (P, 2) fp words; with ``qfp`` (B,) the probe
                  pre-filters on the slot's 2-bit field
      qfp:        optional (B,) query fingerprints
    Returns:
      match_slot (B,) int32 (-1 = miss), empty_slot (B,) int32 (-1 = full)
    """
    S = rows.shape[1] // qkeys.shape[1]
    eq, bits = segment_state(rows, indicators, pairs, qkeys)
    if fps is not None:
        field = slot_fields(fps[pairs.to(torch.int64)], S)
        eq = eq & (field == u32(qfp)[:, None])
    pr = prio[parity.to(torch.int64)].to(torch.int64)
    return rank_select(eq, bits, pr)
