"""`repro_torch.cluster` — sharded multi-node KV serving over the RDMA
transport.

Port of ``repro.cluster``: the rendezvous `Directory` routes one keyspace
over N PM nodes, each node runs any registered `repro_torch.api` scheme as
its shard image (its table on the cluster's device) behind its own
`rdma.RemoteMemory` endpoint, writes replicate primary -> replica under the
remote-persist fence discipline (`replication` proves zero committed-op
loss across every primary-crash prefix), rebalance is crash-consistent
live migration with a one-word token cutover (`migration`), and
`failover` promotes replicas with the schemes' own (indicator-based)
restart.  `sim` scales the YCSB end-to-end simulation to an elastic
N-node cluster (``python -m repro_torch.cluster.sim --smoke``).
"""

from repro_torch.cluster.directory import Directory, key_hash64
from repro_torch.cluster.failover import FailoverController, FailoverReport
from repro_torch.cluster.migration import (MigrationSweep,
                                           build_migration_trace,
                                           migration_crash_sweep,
                                           token_record)
from repro_torch.cluster.replication import (ReplicaCheck,
                                             check_replicated_durability,
                                             op_ack_indices,
                                             replication_plan)
from repro_torch.cluster.store import (ClusterReadResult, ClusterStore,
                                       ClusterWriteResult, RebalanceReport)

__all__ = [
    "Directory", "key_hash64",
    "FailoverController", "FailoverReport",
    "MigrationSweep", "build_migration_trace", "migration_crash_sweep",
    "token_record",
    "ReplicaCheck", "check_replicated_durability", "op_ack_indices",
    "replication_plan",
    "ClusterReadResult", "ClusterStore", "ClusterWriteResult",
    "RebalanceReport",
]
