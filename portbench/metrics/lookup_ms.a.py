"""lookup_ms.a (ms): mean host time of one batch's ``lookup`` call, ending
in a device synchronize.  Layer: read path (``kernels/ops.probe_lookup``,
``core/continuity``).  Source: the benchmark's span around each window
batch's lookup.  Cells: ycsb-a.uniform.  Moves: ops_s."""

from portbench import readers


def read(run):
    return readers.mean_span_ms(run, "lookup")
