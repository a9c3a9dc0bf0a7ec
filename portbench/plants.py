"""Faults and controls planted under a run, for the checks that must fail.

Never active in a benchmark run: ``portbench/control.py`` plants the
control on the chip, and ``portbench/tests/test_faults.py`` plants each
fault on the CPU and sees ``correct`` come out false.  Each plant patches
the program's functions for the length of the run and restores them.

Store cells: ``drop_tails`` (the control: the read path without its
extension and stash tails, which breaks "an acknowledged insert reads
back"), ``stale_update`` (an update that acknowledges and leaves the table
as it was), ``refuse_updates`` (an update that refuses every key and
leaves the table as it was), ``refuse_inserts`` (an insert that stores
and acknowledges only the first half of its batch), ``half_batch`` (a
lookup that serves the first half of its batch and reports the rest
missing), ``alter_answer`` (one value of each lookup batch altered where
it is produced).

Serving cells: ``stale_step`` (a decode step that leaves the cache's
lengths as they were), ``half_batch`` (the second half of the batch's
logits replaced by the first half's), ``alter_token`` (request 0's served
token altered at every step).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _drop_tails():
    from repro_torch.core import continuity as ch

    def no_ext(cfg, table, keys, pair, need):
        B = keys.shape[0]
        return (torch.zeros(B, dtype=torch.bool, device=keys.device),
                torch.zeros(B, dtype=torch.int64, device=keys.device))

    def no_stash(cfg, table, keys, pair, found, values, slot, reads):
        return found, values, slot, reads
    stack = contextlib.ExitStack()
    stack.enter_context(_patched(ch, "_ext_tail", no_ext))
    stack.enter_context(_patched(ch, "_stash_tail", no_stash))
    return stack


def _stale_update():
    from repro_torch.api import ContinuityStore, OpResult
    from repro_torch.core.pmem import CostLedger

    def update(self, table, keys, vals, mask=None):
        n = keys.shape[0]
        ok = torch.ones(n, dtype=torch.bool, device=table.keys.device)
        return table, OpResult(ok=ok, ledger=CostLedger.zero(
            table.keys.device).add(pm_writes=2 * n, ops=n))
    return _patched(ContinuityStore, "update", update)


def _refuse_updates():
    from repro_torch.api import ContinuityStore, OpResult
    from repro_torch.core.pmem import CostLedger

    def update(self, table, keys, vals, mask=None):
        n = keys.shape[0]
        ok = torch.zeros(n, dtype=torch.bool, device=table.keys.device)
        return table, OpResult(ok=ok, ledger=CostLedger.zero(
            table.keys.device).add(ops=n))
    return _patched(ContinuityStore, "update", update)


def _refuse_inserts():
    from repro_torch.api import ContinuityStore
    real = ContinuityStore.insert

    def insert(self, table, keys, vals, mask=None):
        h = keys.shape[0] // 2
        table, res = real(self, table, keys[:h], vals[:h])
        ok = torch.cat([res.ok, torch.zeros(keys.shape[0] - h,
                                            dtype=torch.bool,
                                            device=res.ok.device)])
        return table, res._replace(ok=ok)
    return _patched(ContinuityStore, "insert", insert)


def _half_lookup():
    from repro_torch.api import ContinuityStore
    real = ContinuityStore.lookup

    def lookup(self, table, keys):
        h = keys.shape[0] // 2
        res = real(self, table, keys[:h])
        n = keys.shape[0] - h
        ok = torch.cat([res.ok, torch.zeros(n, dtype=torch.bool,
                                            device=res.ok.device)])
        values = torch.cat([res.values, res.values.new_zeros(n, 4)])
        return res._replace(ok=ok, values=values)
    return _patched(ContinuityStore, "lookup", lookup)


def _alter_answer():
    from repro_torch.api import ContinuityStore
    real = ContinuityStore.lookup

    def lookup(self, table, keys):
        res = real(self, table, keys)
        values = res.values.clone()
        values[0, 0] ^= 1
        ok = res.ok.clone()
        ok[0] = True
        return res._replace(ok=ok, values=values)
    return _patched(ContinuityStore, "lookup", lookup)


def _stale_step():
    from repro_torch.serving import kvcache as KC
    return _patched(KC, "commit_token", lambda cache: cache)


def _half_step():
    from repro_torch.models import transformer as T
    real = T.paged_decode_step

    def step(cfg, params, tokens, cache, geom):
        logits, cache = real(cfg, params, tokens, cache, geom)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:2 * h] = logits[:h]
        return logits, cache
    return _patched(T, "paged_decode_step", step)


def _alter_token():
    from repro_torch.launch import serve
    real = serve.stepper

    def stepper(*args, **kw):
        inner = real(*args, **kw)

        def step(tokens, cache):
            logits, cache = inner(tokens, cache)
            logits = logits.clone()
            worst = logits[0].argmin()
            logits[0, worst] = logits[0].max() + 1.0
            return logits, cache
        return step
    return _patched(serve, "stepper", stepper)


def _none():
    """The fp8 control stands in for the served tokens in the judge
    (``runners/serve.judge``); nothing to patch."""
    return contextlib.nullcontext()


PLANTS = {
    "store": {"drop_tails": _drop_tails, "stale_update": _stale_update,
              "refuse_updates": _refuse_updates,
              "refuse_inserts": _refuse_inserts,
              "half_batch": _half_lookup, "alter_answer": _alter_answer},
    "serve": {"stale_step": _stale_step, "half_batch": _half_step,
              "alter_token": _alter_token, "fp8_control": _none},
}


def planted(kind: str, names) -> contextlib.ExitStack:
    """Every plant of ``names`` for a runner of ``kind``, as one context."""
    stack = contextlib.ExitStack()
    for name in names:
        stack.enter_context(PLANTS[kind][name]())
    return stack
