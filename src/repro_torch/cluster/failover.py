"""Failure detection and replica promotion for the cluster.

Port of ``repro.cluster.failover``.  Detection reuses
`runtime.fault.HeartbeatMonitor` unchanged — cluster nodes heartbeat
(node, step) and a node silent past the timeout is declared dead.
Promotion is where the paper's recovery story pays off at cluster scale:
the surviving replica's table IS the shard (it mirrors every committed
write, fenced — see `cluster.replication`), so failover is

    remove the dead node from the directory (rendezvous re-ranks the
    surviving replica to primary for exactly the dead node's keys),
    run the scheme's restart procedure on the promoted image
    (indicator-based for continuity: scan the commit words, ZERO log),
    re-replicate the shard to restore the replica count.

`FailoverController` packages detect -> promote as a host-side control
loop with an injectable clock, so the N-node sim can drive kill ->
detect -> promote deterministically without real sleeps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.consistency.recovery import RecoveryReport
from repro_torch.runtime.fault import HeartbeatMonitor


@dataclasses.dataclass
class FailoverReport:
    """One completed promotion."""

    dead: str
    promoted_keys: int              # keys whose primary moved off the dead node
    recopied: int                   # replica copies restored post-promotion
    recovery: Dict[str, RecoveryReport]   # per-survivor restart reports

    def recovery_log_free(self) -> bool:
        return all(r.log_free() for r in self.recovery.values())


class FailoverController:
    """detect -> promote loop over a `ClusterStore`.

    ``clock`` is injectable (the sim passes a fake) so the detection
    timeout is deterministic.  ``tick`` is safe to call every round: it
    returns the reports of any promotions it performed (usually none).
    """

    def __init__(self, cluster, timeout_s: float = 5.0,
                 clock: Optional[Callable[[], float]] = None,
                 grace_s: float = 0.0):
        self.cluster = cluster
        kw = {"clock": clock} if clock is not None else {}
        self.monitor = HeartbeatMonitor(timeout_s=timeout_s,
                                        grace_s=grace_s, **kw)
        for name in cluster.node_names():
            self.monitor.register(name)

    def beat(self, step: int) -> None:
        """Heartbeat every node that is actually alive AND reachable (a
        killed node goes silent — that is the failure signal; a
        partitioned node is alive but its beats don't get through, which
        is exactly what the monitor's suspect/grace window exists to
        tell apart from death)."""
        for name in self.cluster.node_names():
            if (self.cluster.is_alive(name)
                    and getattr(self.cluster, "is_reachable",
                                lambda n: True)(name)):
                self.monitor.heartbeat(name, step)

    def tick(self) -> List[FailoverReport]:
        """Detect silent nodes and promote their replicas."""
        reports = []
        for dead in self.monitor.failed_hosts():
            if dead not in self.cluster.node_names():
                continue            # already promoted away
            reports.append(self.cluster.failover(dead))
            self.monitor.hosts.pop(dead, None)
        return reports
