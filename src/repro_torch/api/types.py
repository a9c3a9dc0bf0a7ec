"""The typed hash-store surface: ``HashStore`` protocol, ``ExecPolicy``,
``OpResult`` and the unified ``CostLedger``.

Port of ``repro.api.types``.  A store is a frozen dataclass bundling the
static table geometry, an execution policy and the device its tables live
on; table STATE is a NamedTuple of tensors that the write ops update in
place.  Calling convention:

    table            = store.create()
    table, res       = store.insert(table, keys, vals[, mask])
    table, res       = store.update(table, keys, vals[, mask])
    table, res       = store.delete(table, keys[, mask])
    res              = store.lookup(table, keys)
    lf               = store.load_factor(table)
    info             = store.stats(table)          # host-side dict
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.core.pmem import CostLedger

ENGINES = ("wave", "serial")
PROBES = ("gather", "kernel", "reference")
MUTATES = ("gather", "kernel", "reference")

__all__ = ["CostLedger", "ExecPolicy", "HashStore", "OpResult", "ENGINES",
           "PROBES", "MUTATES"]


@dataclasses.dataclass(frozen=True)
class ExecPolicy:
    """Execution strategy, selected at the API boundary.

    * ``engine`` — server-side mutation strategy: ``"wave"`` (the fused
      wave engine) or ``"serial"`` (the reference's scan oracle, not yet
      ported: continuity raises ``NotImplementedError`` for it).
    * ``probe`` — client read strategy: ``"kernel"`` (the segment-probe
      kernel wrapper: the CUDA kernel on a card, its plain version on the
      CPU), ``"reference"`` (the plain version) or ``"gather"`` (the plain
      candidate gather of ``continuity.lookup``).
    * ``mutate`` — match backend of the fused update/delete: the same
      three values, for the mutation-plan kernel.
    * ``use_fp`` — fingerprint pre-filter in the probe path (default ON;
      result-identical).  The mutation plan always filters.
    """

    engine: str = "wave"
    probe: str = "kernel"
    mutate: str = "kernel"
    use_fp: bool = True

    def __post_init__(self):
        for name, legal in (("engine", ENGINES), ("probe", PROBES),
                            ("mutate", MUTATES)):
            if getattr(self, name) not in legal:
                raise ValueError(f"ExecPolicy.{name} must be one of {legal}, "
                                 f"got {getattr(self, name)!r}")


class OpResult(NamedTuple):
    """Uniform per-batch op result.

    ``ok``     (B,) bool — per-item success (write) / found (lookup).
    ``ledger`` accumulated `CostLedger` for the batch.
    ``values`` (B, VAL_LANES) int32 words — lookup payloads (None on writes).
    ``reads``  (B,) int32 — contiguous fetches per lookup (None on writes).
    ``plan``   `repro_torch.rdma.verbs.VerbPlan` the lookup emitted.
    """

    ok: torch.Tensor
    ledger: CostLedger
    values: Optional[torch.Tensor] = None
    reads: Optional[torch.Tensor] = None
    plan: Optional[Any] = None


@runtime_checkable
class HashStore(Protocol):
    """Structural type every registered scheme satisfies."""

    name: str
    policy: ExecPolicy
    device: str

    def create(self) -> Any: ...

    def insert(self, table: Any, keys, vals, mask=None) -> Tuple[Any, OpResult]: ...

    def update(self, table: Any, keys, vals, mask=None) -> Tuple[Any, OpResult]: ...

    def delete(self, table: Any, keys, mask=None) -> Tuple[Any, OpResult]: ...

    def lookup(self, table: Any, keys) -> OpResult: ...

    def load_factor(self, table: Any) -> torch.Tensor: ...

    def stats(self, table: Any) -> dict: ...
