"""One-sided verb plans: the typed unit of remote access a lookup emits.

Port of ``repro.rdma.verbs``.  A batch of B ops compiles to a (B, M) lane
grid of verbs (lane m of row b = the m-th verb op b would post); the
`CostLedger` of a lookup is derived from its plan.  ``offset`` and
``nbytes`` are int64 here: a full-size table's byte offsets pass 2**31.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.pmem import CostLedger

# verb opcodes
NOOP, READ, WRITE, CAS = 0, 1, 2, 3
VERB_NAMES = {NOOP: "noop", READ: "read", WRITE: "write", CAS: "cas"}

# symbolic remote memory regions
REGION_TABLE, REGION_EXT, REGION_LOG, REGION_STASH = 0, 1, 2, 3
REGION_NAMES = {REGION_TABLE: "table", REGION_EXT: "ext", REGION_LOG: "log",
                REGION_STASH: "stash"}


class VerbPlan(NamedTuple):
    """Batched verb grid: every field is (B, M) — B ops, M verb lanes."""

    verb: torch.Tensor    # (B, M) int32 — NOOP/READ/WRITE/CAS
    region: torch.Tensor  # (B, M) int32 — symbolic MR id
    offset: torch.Tensor  # (B, M) int64 — byte offset within the region
    nbytes: torch.Tensor  # (B, M) int64 — wire payload of the verb
    depth: torch.Tensor   # (B, M) int32 — round-trip dependency depth
    fence: torch.Tensor   # (B, M) bool  — remote-persist fence after (writes)

    @property
    def batch(self) -> int:
        return self.verb.shape[0]

    @property
    def lanes(self) -> int:
        return self.verb.shape[1]


Lane = Tuple  # (verb, region, offset, nbytes, depth, fence) — (B,)-broadcastable

_DTYPES = (torch.int32, torch.int32, torch.int64, torch.int64, torch.int32,
           torch.bool)


def pack(B: int, lane_list: Sequence[Lane], device="cpu") -> VerbPlan:
    """Stack per-lane column tuples into a (B, M) `VerbPlan`; each element
    is a scalar or a (B,) tensor."""
    cols = []
    for i, dtype in enumerate(_DTYPES):
        cols.append(torch.stack(
            [torch.as_tensor(lane[i], device=device).to(dtype).expand(B)
             for lane in lane_list], dim=1))
    return VerbPlan(*cols)


def single_read_plan(B: int, region, offset, nbytes, device="cpu") -> VerbPlan:
    """(B, 1) plan of independent depth-0 READs — one contiguous fetch per
    op, the whole batch behind ONE doorbell."""
    return pack(B, [(READ, region, offset, nbytes, 0, False)], device)


def flatten(plan: VerbPlan) -> VerbPlan:
    """Collapse leading batch dims (e.g. a stacked (S, B, M) plan) to (B', M)."""
    return VerbPlan(*(leaf.reshape(-1, leaf.shape[-1]) for leaf in plan))


def ledger_from_plan(plan: VerbPlan) -> CostLedger:
    """One `CostLedger` derived from a read plan: one READ verb == one
    one-sided contiguous fetch; bytes are the summed wire payloads; ops is
    the batch size."""
    is_read = plan.verb == READ
    return CostLedger.zero(plan.verb.device).add(
        rdma_reads=is_read.sum(),
        bytes_fetched=torch.where(is_read, plan.nbytes, 0).sum(),
        ops=plan.batch)


def reads_per_op(plan: VerbPlan) -> torch.Tensor:
    """(B,) one-sided READ count per op."""
    return (plan.verb == READ).to(torch.int32).sum(dim=1)


def round_trips(plan: VerbPlan) -> torch.Tensor:
    """() dependent round trips the batch needs under doorbell batching:
    1 + the maximum depth of any active verb (0 for an empty plan)."""
    active = plan.verb != NOOP
    return torch.where(active, plan.depth + 1, 0).max()
