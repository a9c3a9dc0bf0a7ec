"""update_ms.a (ms): mean host time of one batch's ``update`` call, ending
in a device synchronize.  Layer: write engine (``core/continuity.update``:
the mutate kernel, the fused rank pass, the residual trips).  Source: the
benchmark's span around each window batch's update.  Cells:
ycsb-a.uniform.  Moves: ops_s."""

from portbench import readers


def read(run):
    return readers.mean_span_ms(run, "update")
