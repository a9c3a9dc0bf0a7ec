"""`repro_torch.consistency` — PM write tracing, crash injection, recovery.

Port of ``repro.consistency``.  The paper's "second bird" (log-free PM
consistency: every op becomes durable via ONE atomic 8-byte indicator
store) reproduced as actual crash semantics, not just Table I write
counts:

  * `trace`    — `PMStore` records (address range, payload, atomicity),
    `PMTrace`, and the crash injector (`crash_states`: every trace
    prefix + every torn split of non-atomic stores; `remote_crash_states`:
    the RDMA-delivery cut between NIC-visible and PM-persisted);
  * `schemes`  — instrumented write paths + recovery per registered
    scheme (continuity: pure indicator-word recovery, zero log; level:
    undo log + duplicate scan; pfarm: RECIPE redo-log replay; dense:
    split commit, unprotected in-place update as negative control);
  * `checker`  — per-op atomic-visibility verification over every crash
    point (`run_case`);
  * `split`    — the online split's crash sweep (`split_crash_sweep`);
  * `matrix`   — the scheme x op gate
    (``python -m repro_torch.consistency.matrix --device cpu``).

States are numpy dicts; tables cross over through ``repro_torch.convert``
and routing runs on the store's device.  `repro_torch.api` stores expose
this as ``store.trace_insert / trace_update / trace_delete`` and
``store.recover`` (see `api_glue`); the serving page table gets
`serving.kvcache.open_new_pages_traced`.
"""

from repro_torch.consistency.api_glue import (TraceResult, recover_store,
                                              trace_store_op)
from repro_torch.consistency.checker import (CaseResult,
                                             all_or_nothing_violations,
                                             run_case, serial_prefix_items)
from repro_torch.consistency.recovery import RecoveryReport
from repro_torch.consistency.schemes import HANDLERS, trace_batch
from repro_torch.consistency.trace import (ATOMIC_BYTES, COMMIT_KINDS, LOG,
                                           CrashState, PMStore, PMTrace,
                                           RemoteCrashState, SubWrite, TraceOp,
                                           apply_trace, crash_states,
                                           fence_after_commits,
                                           fence_every_store,
                                           remote_crash_states, torn_variants,
                                           unpersisted_commits)

__all__ = [
    "ATOMIC_BYTES", "COMMIT_KINDS", "LOG", "CrashState", "PMStore", "PMTrace",
    "RemoteCrashState", "SubWrite",
    "TraceOp", "apply_trace", "crash_states", "torn_variants",
    "fence_after_commits", "fence_every_store", "remote_crash_states",
    "unpersisted_commits",
    "HANDLERS", "trace_batch", "RecoveryReport",
    "CaseResult", "all_or_nothing_violations", "run_case",
    "serial_prefix_items",
    "TraceResult", "recover_store", "trace_store_op",
]
