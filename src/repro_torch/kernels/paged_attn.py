"""Paged-attention kernel: the decode step's attention over the page pool.

Replaces the TPU kernel ``src/repro/kernels/paged_attn.py``
``paged_attention`` (``_paged_attn_kernel``) with the CUDA kernels in
``csrc/paged_attn.cu``: the sequence's physical pages are reached through
the hash-indexed page table, with a float32 online softmax, reading only
live tokens of mapped pages.

Bound: device-memory bytes — each live token's K and V rows once, plus q,
the page table and the output.  Design: split-KV over pages (one block per
(sequence, kv head, split of the page range), float32 partials merged in
split order by a second kernel of the same call); bf16 tiles staged by TMA
bulk copies and multiplied on the tensor cores (mma.sync); float32 q on
CUDA cores, the group's query heads register-tiled over per-warp rings
of bulk copies; see the source.  The host picks the split count
(``_cuda.paged_attn_splits``) without reading the device.  The int8 mode
(``kv_dtype="int8"``: int8 pools with float32 per-(token, head) scales)
stages int8 rows and widens them in shared memory: under bf16 q on the
bf16 kernel's ring and tensor cores (its output equals the bf16 mode's
on the dequantized pools bit for bit), under float32 q in the CUDA-core
loop; its bound is 2 * D + 8 bytes per live token per kv head.

The page-token slice mode (``page_stride``, ``token_offset``: split-KV
decode over a mesh whose model axis splits each page's tokens) reads
pools holding a slice of each page and returns the splits' partials;
``merge_partials`` merges the partials of every slice (the merge kernel
alone).  With one slice the merged partials equal the whole-page output
bit for bit.  A real slice runs the tensor-core kernel's slice
instantiation (three blocks per SM, int8 slice pages staged as runs),
at the split count that fills one wave of its blocks; its int8 route
equals its bf16 route on the dequantized pools bit for bit.

On a CPU tensor the wrappers run the plain versions
(``paged_attn_ref.paged_attention_ref``, ``merge_partials_ref``); on a
CUDA tensor they launch the kernel or raise; on a meta tensor (the
planning tools' dry run) they give the shapes alone.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.paged_attn_ref import (merge_partials_ref,
                                               paged_attention_ref)


def paged_attention(q, kpool, vpool, page_table, seq_lens, scale=None,
                    kscale=None, vscale=None, page_stride=None,
                    token_offset=0):
    """Paged GQA decode attention.

    Args:
      q:          (B, H, D) float32 or bfloat16
      kpool:      (NP, KVH, PS, D) physical pages of q's dtype, or int8
      vpool:      (NP, KVH, PS, D)
      page_table: (B, MAXP) int32 physical page ids (-1 = absent)
      seq_lens:   (B,) int32 live lengths
      kscale, vscale: (NP, KVH, PS, 1) float32 scales of int8 pools
      page_stride, token_offset: the slice mode: the pools hold PS of each
                  page's ``page_stride`` tokens from ``token_offset`` on
    Returns: (B, H, D) in q's dtype; in the slice mode the partials (acc
    (B, H, P, D), ml (B, H, P, 2)) float32 for ``merge_partials``.
    """
    sliced = page_stride is not None
    if q.device.type == "meta":       # shapes only (launch.dryrun)
        if not sliced:
            return torch.empty_like(q)
        B, H, D = q.shape
        return (torch.empty((B, H, 1, D), device="meta"),
                torch.empty((B, H, 1, 2), device="meta"))
    if q.device.type == "cpu":
        return paged_attention_ref(q, kpool, vpool, page_table, seq_lens,
                                   scale=scale, kscale=kscale, vscale=vscale,
                                   page_stride=page_stride,
                                   token_offset=token_offset,
                                   partials=sliced)
    if scale is None:
        scale = float(1.0 / (q.shape[-1] ** 0.5))
    if sliced:
        out = _cuda.launch_paged_attn_slice(
            q, kpool, vpool, page_table, seq_lens, scale, page_stride,
            token_offset, kscale=kscale, vscale=vscale)
    else:
        out = _cuda.launch_paged_attn(q, kpool, vpool, page_table, seq_lens,
                                      scale, kscale=kscale, vscale=vscale)
    if q.shape[0]:                # an empty batch launches nothing
        paged_attention.launches += 1
        if sliced:
            paged_attention.slice_launches += 1
        if kscale is not None:
            paged_attention.int8_launches += 1
        if q.dtype == torch.float32:
            paged_attention.float32_launches += 1
    return out


paged_attention.launches = 0        # kernel launches since the last reset
paged_attention.int8_launches = 0   # of them, launches of the int8 mode
paged_attention.float32_launches = 0  # ... of the float32-q (CUDA-core) loop
paged_attention.slice_launches = 0  # ... of the page-token slice mode


def merge_partials(acc, ml, dtype):
    """Partials acc (..., P, D) and ml (..., P, 2) float32 (the slices'
    splits, in the order they are summed) merged into (..., D) ``dtype``:
    the merge kernel on a card, ``merge_partials_ref`` on the CPU."""
    if acc.device.type == "meta":     # shapes only (launch.dryrun)
        return torch.empty(tuple(acc.shape[:-2]) + acc.shape[-1:],
                           dtype=dtype, device="meta")
    if acc.device.type == "cpu":
        return merge_partials_ref(acc, ml, dtype)
    out = _cuda.launch_paged_attn_merge(acc.contiguous(), ml.contiguous(),
                                        dtype)
    if out.numel():
        merge_partials.launches += 1
    return out


merge_partials.launches = 0         # merge-kernel launches since the reset
