"""PM write traces: the ordered store sequence a batch op issues to PM.

Port of ``repro.consistency.trace`` (numpy only, unchanged in substance).

The paper's consistency claim is about what a crash between INDIVIDUAL PM
stores leaves behind, so the unit here is one PM store, not one op.  A
traced op emits `PMStore` records in issue order; each record carries the
symbolic PM address range it covers, whether the store is a single atomic
8-byte unit (the paper's failure-atomicity granule), whether the paper's
Table I counts it as a PM write, and the concrete table-leaf writes it
performs.  A `PMTrace` is the whole batch's sequence plus per-op metadata.

States under tracing are host-side dicts of numpy arrays (one entry per
table leaf, plus a ``LOG`` region for the logging schemes) — cheap to
snapshot, so the crash injector can materialize EVERY prefix of a trace
(and every torn split of a non-atomic multi-chunk store) as its own
crashed state.  Conversion to/from the schemes' tensor tables happens
only at the store boundary (`repro_torch.consistency.api_glue`), through
``repro_torch.convert``.

Atomicity model (paper §III-C):
  * stores with ``nbytes <= ATOMIC_BYTES`` declared ``atomic=True`` happen
    entirely or not at all (the 8-byte atomic indicator/token commit);
  * larger stores persist in ``ATOMIC_BYTES`` chunks in address order — a
    crash mid-store leaves a TORN value: some leading chunks new, the rest
    old.  ``torn_states`` enumerates every such split.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

ATOMIC_BYTES = 8          # failure-atomicity granule (8-byte atomic store)
LOG = "__log__"           # state key of the PM log region (logging schemes)

State = Dict[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class SubWrite:
    """One table-leaf assignment of a PM store: ``state[field][index] = value``."""

    field: str
    index: tuple
    value: np.ndarray


@dataclasses.dataclass(frozen=True)
class PMStore:
    """One PM store instruction (one would-be flush unit).

    ``kind`` labels the protocol role: ``payload`` (slot key/value bytes),
    ``indicator`` / ``token`` (the scheme's atomic commit word), ``log`` /
    ``log_commit`` / ``log_free`` (RECIPE-style log traffic), ``meta``
    (allocator/pointer metadata the schemes rebuild or re-derive on
    recovery; not Table-I-counted).  ``counts_pm`` mirrors the scheme's
    `CostLedger` accounting so traces and ledgers can be reconciled.
    """

    op_id: int
    kind: str
    atomic: bool
    addr: int
    nbytes: int
    counts_pm: bool
    writes: Tuple[SubWrite, ...]

    def __post_init__(self):
        if self.atomic:
            assert self.nbytes <= ATOMIC_BYTES, (
                f"atomic store of {self.nbytes} B exceeds the "
                f"{ATOMIC_BYTES}-byte atomicity granule")


@dataclasses.dataclass(frozen=True)
class TraceOp:
    """Per-op trace metadata: which records belong to op ``op_id``, whether
    the op succeeded, and which write path it took (``path`` is scheme
    vocabulary: ``plain`` / ``move`` / ``chain`` / ``logged`` / ...)."""

    op_id: int
    op: str              # insert | update | delete
    ok: bool
    path: str
    key: bytes           # 16-byte key image (for the checker's expectations)
    val: Optional[bytes]  # 16-byte value image (None for delete)


@dataclasses.dataclass
class PMTrace:
    """Ordered PM store sequence of one batch op + per-op metadata."""

    scheme: str
    op: str
    records: List[PMStore]
    ops: List[TraceOp]
    order: str = "serial"          # serial | wave

    def pm_writes(self) -> int:
        """Table-I-counted PM writes in this trace (matches the ledger)."""
        return sum(1 for r in self.records if r.counts_pm)

    def log_records(self) -> int:
        """Stores into the PM log region (0 for the log-free schemes)."""
        return sum(1 for r in self.records if r.kind.startswith("log"))

    def crash_points(self) -> int:
        """Whole-store crash boundaries (prefixes, incl. the empty one)."""
        return len(self.records) + 1


# ---------------------------------------------------------------------------
# state plumbing
# ---------------------------------------------------------------------------

def copy_state(state: State) -> State:
    return {k: v.copy() for k, v in state.items()}


def apply_store(state: State, rec: PMStore) -> None:
    """Apply one PM store in place."""
    for w in rec.writes:
        arr = state[w.field]
        if w.index == ():
            state[w.field] = np.asarray(w.value, dtype=arr.dtype).reshape(
                arr.shape)
        else:
            arr[w.index] = np.asarray(w.value, dtype=arr.dtype)


def apply_trace(state: State, trace: PMTrace,
                upto: Optional[int] = None) -> State:
    """Return a copy of ``state`` with the first ``upto`` records applied
    (all of them when ``upto`` is None)."""
    out = copy_state(state)
    for rec in trace.records[:upto]:
        apply_store(out, rec)
    return out


# ---------------------------------------------------------------------------
# crash injection
# ---------------------------------------------------------------------------

def _lane_count(value: np.ndarray) -> int:
    return int(np.asarray(value).size)


def torn_variants(state: State, rec: PMStore) -> Iterator[Tuple[int, PMStore]]:
    """Every torn split of a non-atomic store, given the PRE-store state.

    The store's payload persists in ``ATOMIC_BYTES`` chunks in address
    order; yield ``(chunks_done, partial_record)`` for each proper split.
    Lane granularity is uint32 (4 B), so one chunk = 2 lanes.
    """
    if rec.atomic or rec.nbytes <= ATOMIC_BYTES:
        return
    lanes_per_chunk = max(1, ATOMIC_BYTES // 4)
    total_lanes = sum(_lane_count(w.value) for w in rec.writes)
    nchunks = -(-total_lanes // lanes_per_chunk)
    for j in range(1, nchunks):
        keep = j * lanes_per_chunk          # lanes persisted before the crash
        writes, seen = [], 0
        for w in rec.writes:
            n = _lane_count(w.value)
            old = np.asarray(state[w.field][w.index]).reshape(-1)
            new = np.asarray(w.value).reshape(-1)
            take = int(np.clip(keep - seen, 0, n))
            mixed = np.concatenate([new[:take], old[take:]]).reshape(
                np.asarray(w.value).shape)
            writes.append(SubWrite(w.field, w.index, mixed))
            seen += n
        yield j, dataclasses.replace(rec, writes=tuple(writes))


@dataclasses.dataclass(frozen=True)
class CrashState:
    """One simulated power-loss point: the PM image at that instant."""

    label: str           # e.g. "prefix:7" or "torn:7.2"
    state: State
    records_done: int    # whole records fully persisted
    torn: bool


def crash_states(base: State, trace: PMTrace,
                 include_torn: bool = True) -> Iterator[CrashState]:
    """Enumerate every crash point of ``trace`` starting from ``base``:
    the empty prefix, each whole-record prefix, and (optionally) every
    torn split of each non-atomic multi-chunk store."""
    cur = copy_state(base)
    yield CrashState("prefix:0", copy_state(cur), 0, False)
    for i, rec in enumerate(trace.records):
        if include_torn:
            for j, partial in torn_variants(cur, rec):
                torn = copy_state(cur)
                apply_store(torn, partial)
                yield CrashState(f"torn:{i}.{j}", torn, i, True)
        apply_store(cur, rec)
        yield CrashState(f"prefix:{i + 1}", copy_state(cur), i + 1, False)


# ---------------------------------------------------------------------------
# remote persistence (RDMA writes over the transport layer — DESIGN.md §8)
# ---------------------------------------------------------------------------
# When the stores of a trace arrive as one-sided RDMA WRITEs, a store is
# VISIBLE to concurrent readers as soon as the remote NIC ACKs it (it landed
# in the target's cache hierarchy / DDIO buffer) but only PERSISTED once a
# remote-persist fence — the read-after-WRITE flush of Kashyap et al.,
# "Correct, Fast Remote Persistence" — has drained it to the PM media.  A
# power loss on the server therefore cuts BETWEEN the two: readers may have
# observed state the restarted node no longer has.  ``remote_crash_states``
# materializes exactly that cut for every store boundary.

COMMIT_KINDS = ("indicator", "token", "smeta", "log_commit", "log_free")


@dataclasses.dataclass(frozen=True)
class RemoteCrashState:
    """One remote power-loss point under RDMA-write delivery.

    ``visible``   what concurrent clients could have observed (all stores
                  the NIC ACKed up to the cut);
    ``persisted`` what the restarted server actually has (stores up to the
                  last remote-persist fence) — recovery MUST run on this
                  image, not the visible one.
    """

    label: str
    visible: State
    persisted: State
    records_done: int     # stores NIC-visible at the cut
    fenced_done: int      # stores durably persisted at the cut


def fence_every_store(trace: PMTrace) -> Tuple[int, ...]:
    """The strict discipline: a remote-persist fence after EVERY store
    (each WRITE is flushed before the next issues) — visible == persisted
    at every cut, at one dependent round trip per store."""
    return tuple(range(len(trace.records)))


def fence_after_commits(trace: PMTrace) -> Tuple[int, ...]:
    """The schemes' correctness-minimal discipline: fence after every
    commit-word store (and log commit/free).  Payload stores may be lost
    on power failure — harmless, their commit bit never persisted — but no
    COMMITTED op can be observed and then lost."""
    return tuple(i for i, r in enumerate(trace.records)
                 if r.kind in COMMIT_KINDS)


def remote_crash_states(base: State, trace: PMTrace,
                        fences: Optional[Tuple[int, ...]] = None
                        ) -> Iterator[RemoteCrashState]:
    """Cut the remote node's power after each store's NIC ACK: yield the
    (visible, persisted) image pair per cut.  ``fences`` lists record
    indices AFTER which a remote-persist fence completed (default: the
    commit-fence discipline, `fence_after_commits`)."""
    fset = set(fence_after_commits(trace) if fences is None else fences)
    cur = copy_state(base)
    persisted = copy_state(base)
    fenced = 0
    yield RemoteCrashState("remote:0", copy_state(cur), copy_state(persisted),
                           0, 0)
    for i, rec in enumerate(trace.records):
        apply_store(cur, rec)
        if i in fset:
            persisted = copy_state(cur)
            fenced = i + 1
        yield RemoteCrashState(f"remote:{i + 1}", copy_state(cur),
                               copy_state(persisted), i + 1, fenced)


def unpersisted_commits(trace: PMTrace, cs: RemoteCrashState) -> int:
    """Commit-kind stores a client could have OBSERVED at this cut that the
    restarted server lost — the durability violations an unfenced (write-
    combined) delivery admits.  Zero at every cut under the
    `fence_after_commits` discipline."""
    return sum(1 for i, r in enumerate(trace.records)
               if cs.fenced_done <= i < cs.records_done
               and r.kind in COMMIT_KINDS)
