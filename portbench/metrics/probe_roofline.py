"""probe_roofline (%): the segment-probe kernel's share of its bound.
Layer: kernels (``kernels/csrc/segment_probe.cu``, every mode: the
lookups' probe and the updates' mutation plan).  Source: the profiled
slice's device time of ``segment_probe*`` kernels, against the bytes
those launches need (``counters.probe_bytes``) at the card's 3.35 TB/s.
Cells: the store cells.  Moves: batch_p95_ms."""

from portbench import readers


def read(run):
    return readers.roofline(run, lambda n: "segment_probe" in n,
                            "probe_bytes_profiled")
