"""Fault tolerance and elasticity: the control-plane logic of the port.

Port of ``repro.runtime.fault`` (host-side Python and numpy; the port
keeps its own copy).  Failure handling is structured as detect ->
replace/shrink -> restore -> replay, and every piece composes from
primitives that are real on one device: deterministic data order,
mesh-shape-agnostic sizing, and the hash store's own recovery.

Components:
  * HeartbeatMonitor — failure detection with a configurable timeout and
    a suspicion grace window;
  * plan_remesh — elastic rescale: given the surviving device count, pick
    the largest valid mesh (the data axis shrinks first; the model axis is
    fixed by memory) and return the new mesh shape + the steps to replay;
  * DeterministicSchedule — data order as a pure function of (step,
    shard), so replay after restore is exact;
  * page_table_recovery_drill — the PM side of restore: run the hash
    store's recovery procedure over every shard's crashed page-table image
    (composes with `repro_torch.consistency`'s crash injector);
  * StragglerPolicy — flag hosts whose median step latency exceeds the
    fleet median by a threshold (synchronous steps run at the slowest
    host's pace), for replacement with hot spares.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class HostState:
    last_seen: float
    step: int = 0
    latencies_ms: Optional[List[float]] = None


class HeartbeatMonitor:
    """Failure detection. Hosts report (host_id, step) heartbeats; a host
    silent for ``timeout_s`` becomes SUSPECT, and only after a further
    ``grace_s`` of silence is it declared failed.

    The two-phase declaration distinguishes "node dead" from "node
    partitioned but alive": a partition that heals inside the grace
    window resumes heartbeating, the suspicion clears, and no failover
    fires — without the window, a transient partition and a crash are
    indistinguishable and the controller double-promotes a primary that
    is still alive on the far side.  ``grace_s=0`` keeps the original
    single-timeout behaviour."""

    def __init__(self, timeout_s: float = 30.0, clock=time.monotonic,
                 grace_s: float = 0.0):
        self.timeout = timeout_s
        self.grace = grace_s
        self.clock = clock
        self.hosts: Dict[str, HostState] = {}
        self.suspicions_cleared = 0     # suspect hosts that came back

    def register(self, host_id: str):
        self.hosts[host_id] = HostState(last_seen=self.clock(),
                                        latencies_ms=[])

    def heartbeat(self, host_id: str, step: int,
                  step_latency_ms: Optional[float] = None):
        st = self.hosts[host_id]
        if self.state(host_id) == "suspect":
            self.suspicions_cleared += 1    # partitioned-but-alive came back
        st.last_seen = self.clock()
        st.step = step
        if step_latency_ms is not None:
            st.latencies_ms.append(step_latency_ms)
            del st.latencies_ms[:-100]

    def state(self, host_id: str) -> str:
        """``alive`` | ``suspect`` (silent past timeout, inside the grace
        window) | ``failed`` (silent past timeout + grace)."""
        silent = self.clock() - self.hosts[host_id].last_seen
        if silent > self.timeout + self.grace:
            return "failed"
        return "suspect" if silent > self.timeout else "alive"

    def suspect_hosts(self) -> List[str]:
        return [h for h in self.hosts if self.state(h) == "suspect"]

    def failed_hosts(self) -> List[str]:
        return [h for h in self.hosts if self.state(h) == "failed"]


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    restore_step: int
    replay_steps: int
    dropped_chips: int


def plan_remesh(total_chips: int, failed_chips: int, model_axis: int,
                checkpoint_step: int, current_step: int,
                pod_axis: int = 1) -> RemeshPlan:
    """Elastic rescale after losing ``failed_chips``.

    TP (model axis) is fixed — it is set by per-chip memory. The DATA axis is
    elastic: shrink it to the largest value that fits the survivors. Global
    batch stays constant (microbatch count rises), so training dynamics are
    unchanged; throughput degrades proportionally instead of stopping.
    """
    survivors = total_chips - failed_chips
    per_replica = model_axis * pod_axis
    new_data = survivors // per_replica
    if new_data < 1:
        raise RuntimeError("not enough survivors for one model replica")
    shape = ((pod_axis, new_data, model_axis) if pod_axis > 1
             else (new_data, model_axis))
    axes = (("pod", "data", "model") if pod_axis > 1 else ("data", "model"))
    return RemeshPlan(
        mesh_shape=shape, mesh_axes=axes,
        restore_step=checkpoint_step,
        replay_steps=current_step - checkpoint_step,
        dropped_chips=survivors - new_data * per_replica)


class DeterministicSchedule:
    """Data order as a pure function of (step, shard): replay-exact."""

    def __init__(self, seed: int, global_batch: int):
        self.seed = seed
        self.global_batch = global_batch

    def batch_indices(self, step: int, shard: int, num_shards: int):
        import numpy as np
        per = self.global_batch // num_shards
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, step, shard]))
        return rng.integers(0, 2 ** 31, size=(per,), dtype=np.int64)


@dataclasses.dataclass
class StragglerReport:
    host: str
    p50_ms: float
    host_p50_ms: float
    severity: float


def page_table_recovery_drill(store, shard_states):
    """Restart drill for a failed serving node: run the page-table store's
    recovery procedure (`repro_torch.api` ``store.recover``) on every shard's
    crashed PM image and aggregate the per-shard recovery work.

    ``shard_states`` — one crashed state (or table pytree) per data shard,
    e.g. `repro_torch.consistency.CrashState.state` images of an interrupted
    `serving.kvcache.open_new_pages_traced` batch.  Returns ``(tables,
    merged RecoveryReport)``; the merged report is the restart cost of the
    node (for continuity page tables: indicator words scanned, ZERO log
    records — the paper's log-free recovery claim at serving scale).
    """
    from repro_torch.consistency import RecoveryReport
    tables, merged = [], RecoveryReport(store.name)
    for st in shard_states:
        table, report = store.recover(st)
        tables.append(table)
        merged = merged.merge(report)
    return tables, merged


class StragglerPolicy:
    """Synchronous-SPMD straggler detection: a host whose median step latency
    exceeds the fleet median by ``threshold``x is flagged (for hot-spare
    swap at the next checkpoint boundary)."""

    def __init__(self, threshold: float = 1.15, min_samples: int = 20):
        self.threshold = threshold
        self.min_samples = min_samples

    def analyze(self, monitor: HeartbeatMonitor) -> List[StragglerReport]:
        import numpy as np
        meds = {h: float(np.median(st.latencies_ms))
                for h, st in monitor.hosts.items()
                if st.latencies_ms and len(st.latencies_ms) >= self.min_samples}
        if len(meds) < 2:
            return []
        fleet = float(np.median(list(meds.values())))
        return [StragglerReport(h, fleet, m, m / fleet)
                for h, m in sorted(meds.items())
                if m > fleet * self.threshold]
