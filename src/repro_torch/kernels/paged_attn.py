"""Paged-attention kernel: the decode step's attention over the page pool.

Replaces the TPU kernel ``src/repro/kernels/paged_attn.py``
``paged_attention`` (``_paged_attn_kernel``) with the CUDA kernel in
``csrc/paged_attn.cu``: for each (sequence, kv head) it walks the
sequence's physical pages through the hash-indexed page table and keeps a
float32 online softmax, reading only live tokens of mapped pages.

Bound: device-memory bytes — each live token's K and V rows once, plus q,
the page table and the output.  Design: one block per (sequence, kv head,
up to 8 query heads), one warp per query head, K/V tiles staged in shared
memory with 16-byte loads; see the source.

On a CPU tensor the wrapper runs the plain version
(``paged_attn_ref.paged_attention_ref``); on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

from repro_torch.kernels import _cuda
from repro_torch.kernels.paged_attn_ref import paged_attention_ref


def paged_attention(q, kpool, vpool, page_table, seq_lens, scale=None):
    """Paged GQA decode attention.

    Args:
      q:          (B, H, D) float32 or bfloat16
      kpool:      (NP, KVH, PS, D) physical pages of q's dtype
      vpool:      (NP, KVH, PS, D)
      page_table: (B, MAXP) int32 physical page ids (-1 = absent)
      seq_lens:   (B,) int32 live lengths
    Returns: (B, H, D) in q's dtype.
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, kpool, vpool, page_table, seq_lens,
                                   scale=scale)
    if scale is None:
        scale = float(1.0 / (q.shape[-1] ** 0.5))
    out = _cuda.launch_paged_attn(q, kpool, vpool, page_table, seq_lens,
                                  scale)
    if q.shape[0]:                # an empty batch launches nothing
        paged_attention.launches += 1
    return out


paged_attention.launches = 0   # kernel launches since the last reset
