"""reads_per_lookup (reads/op): contiguous fetches per lookup, the paper's
access amplification.  Layer: verb plan / ledger (``rdma/verbs``,
``core/pmem.CostLedger``).  Source: the ledger every lookup of the window
returns (``rdma_reads`` over ``ops``), an exact count.  Cells: the store
cells.  Moves: batch_p95_ms."""


def read(run):
    ops = run.counters.get("lookup_ops", 0)
    if not ops:
        return None
    return run.counters["rdma_reads"] / ops
