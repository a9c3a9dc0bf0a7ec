"""`repro_torch.rdma` — the one-sided transport layer.

Port of ``repro.rdma``:

  * `verbs`     — `VerbPlan` (the (B, M) verb grid a scheme's lookup
    emits: READ/WRITE/CAS over symbolic regions, with dependency depths and
    remote-persist fences) and the `ledger_from_plan` accounting helper;
  * `transport` — `RemoteMemory` (doorbell batching: one round trip per
    dependency depth) + `LinkModel` (every calibrated latency constant);
  * `sim`       — the end-to-end YCSB simulation: per-scheme throughput and
    p50/p99 latency, as `LinkModel` prices them.

`api.ExecPolicy(transport="sim")` selects the endpoint
(`RemoteMemory.from_policy`).
"""

from repro_torch.rdma.transport import Completion, LinkModel, RemoteMemory
from repro_torch.rdma.verbs import (CAS, NOOP, READ, REGION_EXT, REGION_LOG,
                                    REGION_TABLE, WRITE, VerbPlan, flatten,
                                    ledger_from_plan, pack, reads_per_op,
                                    round_trips)

__all__ = [
    "Completion", "LinkModel", "RemoteMemory",
    "NOOP", "READ", "WRITE", "CAS",
    "REGION_TABLE", "REGION_EXT", "REGION_LOG",
    "VerbPlan", "flatten", "ledger_from_plan", "pack", "reads_per_op",
    "round_trips",
]
