"""device_idle.store (%): share of the window in which no device operation
ran.  Layer: device (the card).  Source: the profiler's trace over
``profile_batches`` batches after the window (drawn before the slice
opens), busy seconds per batch against the window's seconds per batch.
Cells: the store cells.  Moves: batch_p95_ms."""

from portbench import readers


def read(run):
    return readers.device_idle(run)
