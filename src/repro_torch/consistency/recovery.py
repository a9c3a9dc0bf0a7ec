"""Recovery accounting: what a restart has to READ and REPAIR per scheme.

Port of ``repro.consistency.recovery`` (numpy only, unchanged in substance).

The paper's contrast is not "can the scheme recover" (all of them can with
enough machinery) but what recovery COSTS:

  * continuity — a pure function of the per-pair indicator words: scan P
    words, recompute derived counters, done.  ZERO log records exist, zero
    payload bytes are read (`RecoveryReport.log_records_scanned == 0`).
  * level     — token-word scan + rollback of any committed-but-live undo
    log entry (the logged in-place update fallback) + a duplicate-key scan
    (an interrupted slot movement can leave the moved item visible twice).
  * pfarm     — RECIPE redo: token scan + full log scan; every committed,
    non-invalidated entry is replayed against the table.
  * dense     — live-bit scan; in-place updates are UNPROTECTED (1 PM
    write, no log, no out-of-place commit), so a torn update survives
    recovery — the negative control the crash matrix asserts.

`RecoveryReport` is the per-restart cost ledger the crash matrix
(`repro_torch.consistency.matrix`) merges over every crash point of a cell.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RecoveryReport:
    """What one recovery pass read and repaired."""

    scheme: str
    commit_words_scanned: int = 0     # indicator / token words read
    log_records_scanned: int = 0      # log entries examined
    log_records_used: int = 0         # entries rolled back or replayed
    payload_slots_scanned: int = 0    # slots read beyond commit words
    duplicates_cleared: int = 0       # level movement-crash repair
    repairs: int = 0                  # table stores issued by recovery

    def merge(self, other: "RecoveryReport") -> "RecoveryReport":
        assert other.scheme == self.scheme
        return RecoveryReport(
            self.scheme,
            *(getattr(self, f.name) + getattr(other, f.name)
              for f in dataclasses.fields(self)[1:]))

    def log_free(self) -> bool:
        return self.log_records_scanned == 0 and self.log_records_used == 0


def popcount(a: np.ndarray) -> np.ndarray:
    """Per-element set-bit count of an unsigned integer array."""
    a = np.asarray(a)
    return np.unpackbits(a.view(np.uint8), axis=None).reshape(
        a.size, -1).sum(axis=1).reshape(a.shape)
