"""Persistent-memory cost accounting (the paper's evaluation metrics).

Port of ``repro.core.pmem``: ``CostLedger`` is the one counter tuple every
op returns — PM writes (cache-line flushes, the paper's Table I), one-sided
contiguous fetches (access amplification) and fetched bytes.  Counters are
0-d int64 tensors on the device the op ran on, so a batch's ledger costs
no host round trip until a caller reads a per-op average.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CostLedger(NamedTuple):
    """Accumulated counters, each a 0-d int64 tensor."""

    pm_writes: torch.Tensor      # cache-line flushes issued
    rdma_reads: torch.Tensor     # one-sided contiguous fetches issued
    bytes_fetched: torch.Tensor  # total fetched payload (bytes)
    ops: torch.Tensor            # ACTIVE operations accounted

    @staticmethod
    def zero(device="cpu") -> "CostLedger":
        z = torch.zeros((), dtype=torch.int64, device=device)
        return CostLedger(z, z, z, z)

    def add(self, pm_writes=0, rdma_reads=0, bytes_fetched=0,
            ops=0) -> "CostLedger":
        dev = self.pm_writes.device

        def t(x):
            return torch.as_tensor(x, device=dev).to(torch.int64)

        return CostLedger(self.pm_writes + t(pm_writes),
                          self.rdma_reads + t(rdma_reads),
                          self.bytes_fetched + t(bytes_fetched),
                          self.ops + t(ops))

    def merge(self, other: "CostLedger") -> "CostLedger":
        return CostLedger(*(a + b for a, b in zip(self, other)))

    # -- per-op averages (host-side floats; the paper's table cells) --------
    def _per_op(self, x) -> float:
        n = float(self.ops)
        return float(x) / n if n else 0.0

    def pm_per_op(self) -> float:
        """Average PM writes per op (Table I cell)."""
        return self._per_op(self.pm_writes)

    def reads_per_op(self) -> float:
        """Average contiguous fetches per op (access amplification)."""
        return self._per_op(self.rdma_reads)

    def bytes_per_op(self) -> float:
        return self._per_op(self.bytes_fetched)


CACHE_LINE = 64


def lines_touched(nbytes: int) -> int:
    """Number of cache lines covered by an aligned store of ``nbytes``."""
    return max(1, (nbytes + CACHE_LINE - 1) // CACHE_LINE)
