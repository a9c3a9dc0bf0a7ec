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

    state            = store.begin_resize(table[, factor, step_slo_us])
    state            = store.resize_step(state[, budget])
    store2, table2   = store.resize_cutover(state)

    table, traced    = store.trace_insert(table, keys, vals[, mask])
    table2, report   = store.recover(table_or_crash_state)
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.core.pmem import CostLedger

ENGINES = ("wave", "serial")
PROBES = ("gather", "kernel", "reference")
MUTATES = ("gather", "kernel", "reference")
TRANSPORTS = ("none", "sim")

__all__ = ["CostLedger", "ExecPolicy", "HashStore", "OpResult",
           "ResizeState", "ENGINES", "PROBES", "MUTATES", "TRANSPORTS"]


@dataclasses.dataclass(frozen=True)
class ExecPolicy:
    """Execution strategy, selected at the API boundary.

    * ``engine`` — server-side mutation strategy: ``"wave"`` (the fused
      wave engine) or ``"serial"`` (the serial oracles: one op at a time
      in batch order, byte-identical to the wave engine).
    * ``probe`` — client read strategy: ``"kernel"`` (the segment-probe
      kernel wrapper: the CUDA kernel on a card, its plain version on the
      CPU), ``"reference"`` (the plain version) or ``"gather"`` (the plain
      candidate gather of ``continuity.lookup``).
    * ``mutate`` — match backend of the fused update/delete: the same
      three values, for the mutation-plan kernel.
    * ``use_fp`` — fingerprint pre-filter in the probe path (default ON;
      result-identical).  The mutation plan always filters.
    * ``transport`` — what host-side drivers post the verb plans to:
      ``"none"`` (plans price the `CostLedger` only) or ``"sim"`` (a
      `repro_torch.rdma.RemoteMemory` endpoint with doorbell batching and
      the analytical latency model; ``RemoteMemory.from_policy(policy)``).

    Level, pfarm and dense have one write strategy (the serial walk or
    batched torch ops) and no read kernel: they accept every value of
    ``engine``, ``probe`` and ``mutate`` and ignore them.
    """

    engine: str = "wave"
    probe: str = "kernel"
    mutate: str = "kernel"
    use_fp: bool = True
    transport: str = "none"

    def __post_init__(self):
        for name, legal in (("engine", ENGINES), ("probe", PROBES),
                            ("mutate", MUTATES), ("transport", TRANSPORTS)):
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


@dataclasses.dataclass(frozen=True)
class ResizeState:
    """Handle of one in-flight incremental resize (begin -> step* -> cutover).

    ``store``/``table`` are the SOURCE geometry and its (draining) state;
    ``new_store``/``new_table`` the grown target.  ``opaque`` is the
    scheme's private cursor (continuity: its per-pair cutover-token split
    state); ``done`` flips when every cohort has moved; ``moved`` counts
    relocated items and ``n_items`` records the live count at begin (the
    cutover loss check).  ``step_budget`` is the per-step cohort count the
    SLO controller chose at begin (``begin_resize(step_slo_us=...)`` sizes
    it from the `LinkModel` so one step's foreground stall stays under the
    target; None means the caller passes an explicit budget).

    Each step returns a new handle, but continuity's tables and tokens
    are updated in place, as every write op of the port is: all handles
    of one continuity resize name the same live state.  A step replayed
    from an older handle leaves the tables as they were: continuity's
    split inserts only the items the grown table does not hold yet (its
    ``moved`` then counts only what this replay moved), and the generic
    one-step rehash of the baselines fills a fresh grown table."""

    store: "HashStore"
    new_store: "HashStore"
    table: Any
    new_table: Any
    factor: int = 2
    opaque: Any = None
    done: bool = False
    n_items: int = 0
    moved: int = 0
    step_budget: Optional[int] = None


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

    # incremental maintenance surface: begin one resize, advance it a
    # bounded number of cohorts at a time (foreground traffic keeps
    # flowing between steps), then cut over.  ``resize`` is the deprecated
    # one-shot shim over the triple.
    def begin_resize(self, table: Any, factor: int = 2,
                     step_slo_us: Optional[float] = None) -> ResizeState: ...

    def resize_step(self, state: ResizeState,
                    budget: Optional[int] = None) -> ResizeState: ...

    def resize_cutover(self, state: ResizeState) -> Tuple["HashStore", Any]: ...

    def resize(self, table: Any, factor: int = 2) -> Tuple["HashStore", Any]: ...

    def load_factor(self, table: Any) -> torch.Tensor: ...

    def stats(self, table: Any) -> dict: ...

    # crash-consistency surface (`repro_torch.consistency`): traced twins
    # of the write ops — same (table, result) contract, but the result
    # carries the ordered PM store trace the crash injector replays — and
    # the scheme's restart procedure (returns (table, RecoveryReport)).
    def trace_insert(self, table: Any, keys, vals, mask=None) -> Tuple[Any, Any]: ...

    def trace_update(self, table: Any, keys, vals, mask=None) -> Tuple[Any, Any]: ...

    def trace_delete(self, table: Any, keys, mask=None) -> Tuple[Any, Any]: ...

    def recover(self, table_or_state: Any) -> Tuple[Any, Any]: ...
