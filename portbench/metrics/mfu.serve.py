"""mfu.serve (%): the whole serving loop's share of the card's bf16 peak:
the FLOPs the window's requests need (``counters.group_flops``: each
layer's matmuls per token, causal attention's lower triangle, the output
head only where logits are used) over the window's seconds and 989e12
(the H100 SXM's dense bf16 rate at 700 W).  Layer: model
(``models/transformer``).  Cells: yi6b.docqa.  Moves: tokens_s."""

from portbench import counters as C


def read(run):
    flops = run.counters.get("flops_window", 0)
    window = run.facts.get("window_s", 0)
    if not flops or window <= 0:
        return None
    return flops / window / C.PEAK_BF16_FLOPS * 100
