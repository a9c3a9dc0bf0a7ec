"""device_idle.serve (%): share of the window in which no device operation
ran.  Layer: device (the card).  Source: the profiler's trace over one
group after the window, busy seconds per group against the window's
seconds per group.  Cells: yi6b.docqa.  Moves: tokens_s."""

from portbench import readers


def read(run):
    return readers.device_idle(run)
