"""attn_roofline (%): the paged-attention kernel's share of its bound.
Layer: kernels (``kernels/csrc/paged_attn.cu``, the bf16 mode).  Source:
the profiled slice's device time of ``split_kernel_bf16`` and
``merge_kernel``, against the K/V bytes its decode steps need
(``counters.attn_bytes`` per layer and step) at the card's 3.35 TB/s.
Cells: yi6b.docqa.
Moves: tokens_s."""

from portbench import readers


def read(run):
    return readers.roofline(
        run, lambda n: "split_kernel_bf16" in n or "merge_kernel" in n,
        "attn_bytes_profiled")
