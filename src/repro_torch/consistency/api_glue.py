"""Store <-> `repro_torch.consistency` glue: traced store ops + recovery.

Port of ``repro.consistency.api_glue``.  `HashStore` adapters call these
from their ``trace_*`` / ``recover`` methods (a deferred import on the
stores' side keeps `repro_torch.api` importable without this package).
A traced op updates the table IN PLACE, as the port's untraced write ops
do, to the state its trace lands on (semantically identical to the
untraced op's; byte-identical for the non-scrubbing schemes), and returns
a `TraceResult` with the PM store trace and a ledger reconciled with the
scheme's own `CostLedger` accounting.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.consistency.schemes import HANDLERS, trace_batch
from repro_torch.consistency.trace import PMTrace
from repro_torch.core.pmem import CostLedger


class TraceResult(NamedTuple):
    """Result of a traced store op.

    ``ok``     (B,) numpy bool — per-op success, as the untraced op;
    ``trace``  the ordered `PMTrace` (records + per-op metadata);
    ``ledger`` a `CostLedger` (on the store's device) built from the
    trace's Table-I-counted records — equal to the untraced op's ledger
    whenever every op took a path the scheme's flat per-op cost models.
    """

    ok: np.ndarray
    trace: PMTrace
    ledger: CostLedger


def trace_store_op(store, table, op: str, keys, vals=None, mask=None):
    """Run ``op`` under PM-write tracing; returns ``(table, TraceResult)``.

    ``table`` is updated in place and returned; a numpy state (a
    `CrashState.state`) is accepted too and gives a new table on the
    store's device.  The trace order follows the store's `ExecPolicy`:
    continuity with ``engine="wave"`` emits the wave engine's schedule
    (per wave: payload stores then one-word commits), everything else the
    serial batch order.
    """
    handler = HANDLERS[store.name]
    order = ("wave" if store.name == "continuity"
             and store.policy.engine == "wave" else "serial")
    state, trace = trace_batch(handler, store.cfg, table, op, keys, vals,
                               mask, order=order, device=store.device)
    # rebuild the derived (non-traced) counters — NOT a full recovery: the
    # final state is uncrashed, so repair actions (log rollback, duplicate
    # scan) must not run here (level legitimately holds duplicates after a
    # duplicate-key insert, exactly as the untraced path does)
    state = handler.rebuild_counts(store.cfg, state)
    new_table = handler.state_to_table(store.cfg, state, store.device)
    if isinstance(table, dict):
        table = new_table
    else:
        for dst, src in zip(table, new_table):
            dst.copy_(src)
    ok = np.array([o.ok for o in trace.ops], bool)
    active = sum(1 for o in trace.ops if o.path != "masked")
    ledger = CostLedger.zero(store.device).add(pm_writes=trace.pm_writes(),
                                               ops=active)
    return table, TraceResult(ok, trace, ledger)


def recover_store(store, table_or_state):
    """Run the scheme's restart procedure; returns ``(table,
    RecoveryReport)`` with a NEW table on the store's device.

    Accepts a scheme table or a crash-injected numpy state (a
    `CrashState.state`, which carries the PM log region for the logging
    schemes).  Recovering a table that was never crashed is a no-op apart
    from recomputing derived counters — recovery is idempotent.
    """
    handler = HANDLERS[store.name]
    state = handler.init_state(store.cfg, table_or_state)
    state, report = handler.recover(store.cfg, state)
    return handler.state_to_table(store.cfg, state, store.device), report
