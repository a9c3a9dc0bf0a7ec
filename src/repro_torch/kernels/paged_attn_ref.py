"""Plain PyTorch version of paged decode attention (GQA) over a page pool.

Port of ``repro.kernels.paged_attn_ref``; the CPU path of
``paged_attn.paged_attention`` and the card's yardstick for its kernel.
It gathers every page of the table, so it moves (B, MAXP, KVH, PS, D)
copies that the kernel never makes.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def paged_attention_ref(q, kpool, vpool, page_table, seq_lens, scale=None):
    """Reference paged decode attention.

    Args:
      q:          (B, H, D) — one new query token per sequence
      kpool:      (NP, KVH, PS, D) physical key pages (page-major contiguous)
      vpool:      (NP, KVH, PS, D)
      page_table: (B, MAXP) int32 — physical page per logical page (-1 = absent)
      seq_lens:   (B,) int32 — tokens currently in each sequence's cache
    Returns:
      (B, H, D) attention output, same dtype as q.
    """
    B, H, D = q.shape
    NP, KVH, PS, _ = kpool.shape
    MAXP = page_table.shape[1]
    G = H // KVH
    if scale is None:       # 1/sqrt(D) rounded to float32, as the reference
        scale = (1.0 / torch.sqrt(torch.tensor(float(D)))).item()

    pt = page_table.clamp(min=0).long()
    k = kpool[pt]                                  # (B, MAXP, KVH, PS, D)
    v = vpool[pt]
    k = k.movedim(2, 1).reshape(B, KVH, MAXP * PS, D)
    v = v.movedim(2, 1).reshape(B, KVH, MAXP * PS, D)
    qg = q.reshape(B, KVH, G, D).to(F32)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k.to(F32)) * scale

    pos = torch.arange(MAXP * PS, device=q.device)[None]     # (1, T)
    live = (pos < seq_lens[:, None]) & torch.repeat_interleave(
        page_table >= 0, PS, dim=1)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bkgt,bktd->bkgd", p, v.to(F32))
    return out.reshape(B, H, D).to(q.dtype)
