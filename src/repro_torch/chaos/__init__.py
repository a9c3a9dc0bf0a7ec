"""Chaos engineering for the cluster: seeded fault scenarios + the matrix.

Port of ``repro.chaos``; every scenario's cluster runs on ``device`` (the
card unless the caller asks for the CPU).

The subsystem turns the failure machinery grown across the repo — crash
storms (`cluster.store.kill` + `FailoverController`), network partitions
with epoch fencing (`partition`/`heal`/`resync`/`stale_write`), delivery
faults with retry/timeout/backoff (`rdma.transport.FaultInjector` +
`RetryPolicy`), quorum-loss read-only degradation — into a SEEDED
scenario grid whose every cell is audited by the zero-committed-loss
re-read and the fencing-completeness count
(``stale_acks_detected == stale_acks_injected``).

    python -m repro_torch.chaos.matrix --smoke --seed 0 [--device cpu]

runs the CI grid; `scenarios.run_scenario` runs one named cell.
"""

from repro_torch.chaos.scenarios import (SCENARIOS, run_scenario)  # noqa: F401
