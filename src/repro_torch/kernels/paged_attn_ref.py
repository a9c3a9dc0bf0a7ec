"""Plain PyTorch version of paged decode attention (GQA) over a page pool.

Port of ``repro.kernels.paged_attn_ref``; the CPU path of
``paged_attn.paged_attention`` and the card's yardstick for its kernel.
It gathers every page of the table, so it moves (B, MAXP, KVH, PS, D)
copies that the kernel never makes.  With int8 pools and their float32
per-(token, head) scales, the gathered pages are dequantized to q's dtype
as the reference's ``_paged_layer_step`` does (multiplied in float32,
rounded once to the model's dtype) before the same softmax.  The int8
rule itself, ``quant_store`` and ``dequant``, lives here once: the KV
cache, the merged decode path and this yardstick all use it.

The page-token slice mode (split-KV decode over a mesh whose model axis
splits each page's tokens) attends over a slice of each page and returns
partials; ``merge_partials_ref`` merges the slices' partials as the
kernel's merge does.
"""

from __future__ import annotations

import torch

F32 = torch.float32


# -- int8 quantization (beyond-paper serving optimization) -------------------

def quant_store(x: torch.Tensor):
    """Symmetric per-(token, head) int8 quant, the reference's float32
    arithmetic: x (..., D) -> (int8 (..., D), float32 scale (..., 1));
    scale = max(amax, 1e-8) / 127, round half to even, clip to +-127."""
    xf = x.to(F32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 values times their float32 scales, rounded once to dtype."""
    return (q.to(F32) * scale).to(dtype)


def paged_attention_ref(q, kpool, vpool, page_table, seq_lens, scale=None,
                        kscale=None, vscale=None, page_stride=None,
                        token_offset=0, partials=False):
    """Reference paged decode attention.

    Args:
      q:          (B, H, D) — one new query token per sequence
      kpool:      (NP, KVH, PS, D) physical key pages (page-major contiguous)
      vpool:      (NP, KVH, PS, D)
      page_table: (B, MAXP) int32 — physical page per logical page (-1 = absent)
      seq_lens:   (B,) int32 — tokens currently in each sequence's cache
      kscale, vscale: (NP, KVH, PS, 1) float32 scales of int8 pools, or
                  None for pools in q's dtype
      page_stride, token_offset: the page-token slice mode: the pools hold
                  PS of each page's ``page_stride`` tokens, from token
                  ``token_offset`` on (local row j of logical page p is
                  token p * page_stride + token_offset + j); None: whole
                  pages
      partials:   return the slice's partials for ``merge_partials_ref``
                  instead of the output
    Returns:
      (B, H, D) attention output, same dtype as q; with ``partials``,
      (acc (B, H, 1, D), ml (B, H, 1, 2)) float32: the slice's normalised
      output and (its log-sum-exp, 1), or (zeros, (-inf, 0)) for a slice
      with no live token.
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
    if kscale is not None:          # int8 pages: dequantize to q's dtype
        k = dequant(k, kscale[pt], q.dtype)
        v = dequant(v, vscale[pt], q.dtype)
    k = k.movedim(2, 1).reshape(B, KVH, MAXP * PS, D)
    v = v.movedim(2, 1).reshape(B, KVH, MAXP * PS, D)
    qg = q.reshape(B, KVH, G, D).to(F32)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k.to(F32)) * scale

    pos = torch.arange(MAXP * PS, device=q.device)
    stride = PS if page_stride is None else page_stride
    tok = (pos // PS) * stride + token_offset + pos % PS   # pos: whole pages
    live = (tok[None] < seq_lens[:, None]) & torch.repeat_interleave(
        page_table >= 0, PS, dim=1)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    top = s.amax(-1, keepdim=True)
    p = torch.exp(s - top)
    total = p.sum(-1, keepdim=True)
    p = p / total
    out = torch.einsum("bkgt,bktd->bkgd", p, v.to(F32))
    if not partials:
        return out.reshape(B, H, D).to(q.dtype)
    empty = ~live.any(1)[:, None, None, None]
    acc = torch.where(empty, 0.0, out).reshape(B, H, 1, D)
    lse = torch.where(empty, float("-inf"), top + torch.log(total))
    ml = torch.stack([lse, (~empty).to(F32).expand_as(lse)], -1)
    return acc, ml.reshape(B, H, 1, 2)


def merge_partials_ref(acc, ml, dtype):
    """Partials of slices (and splits) merged into the output: acc (..., P,
    D) and ml (..., P, 2) float32, (m, l) per partial, summed in P order,
    each weighed by exp(m - max m) (0 for an empty one, m = -inf); the
    output acc-sum / max(l-sum, 1e-30) in ``dtype`` (zeros where every
    partial is empty), as the kernel's merge.  One partial of the plain
    slice mode, (out, (lse, 1)), gives out back bit for bit."""
    m, l = ml[..., 0], ml[..., 1]
    top = m.amax(-1, keepdim=True)
    w = torch.where(m == float("-inf"), 0.0, torch.exp(m - top))
    total = (w * l).sum(-1, keepdim=True).clamp(min=1e-30)
    return ((w[..., None] * acc).sum(-2) / total).to(dtype)
