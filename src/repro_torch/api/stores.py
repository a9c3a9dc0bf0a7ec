"""The continuity store behind the `HashStore` protocol.

Port of ``repro.api.stores`` (continuity only in this port).  The store is
a frozen dataclass binding the scheme module's functions to the protocol's
calling convention, the unified `OpResult`/`CostLedger`, an `ExecPolicy`
and the device its tables live on.  Write ops update the table in place
and return it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, ClassVar, Tuple

import torch

from repro_torch.api.types import ExecPolicy, OpResult
from repro_torch.core import continuity as ch
from repro_torch.rdma import verbs as rv


@dataclasses.dataclass(frozen=True)
class _ModuleStore:
    """Shared plumbing: scheme-module functions -> protocol methods."""

    cfg: Any
    policy: ExecPolicy = ExecPolicy()
    device: str = "cuda"

    name: ClassVar[str] = "?"

    # -- per-scheme hooks ---------------------------------------------------
    @property
    def _mod(self):
        raise NotImplementedError

    def _insert_fn(self):
        return self._mod.insert

    def _update_fn(self):
        return self._mod.update

    def _delete_fn(self):
        return self._mod.delete

    def _lookup_res(self, table, keys):
        return self._mod.lookup(self.cfg, table, keys)

    def total_slots(self, table=None) -> float:
        raise NotImplementedError

    # -- protocol -----------------------------------------------------------
    def with_policy(self, policy: ExecPolicy) -> "_ModuleStore":
        return dataclasses.replace(self, policy=policy)

    def create(self):
        return self._mod.create(self.cfg, self.device)

    def insert(self, table, keys, vals, mask=None) -> Tuple[Any, OpResult]:
        table, ok, ctr = self._insert_fn()(self.cfg, table, keys, vals, mask)
        return table, OpResult(ok=ok, ledger=ctr)

    def update(self, table, keys, vals, mask=None) -> Tuple[Any, OpResult]:
        table, ok, ctr = self._update_fn()(self.cfg, table, keys, vals, mask)
        return table, OpResult(ok=ok, ledger=ctr)

    def delete(self, table, keys, mask=None) -> Tuple[Any, OpResult]:
        table, ok, ctr = self._delete_fn()(self.cfg, table, keys, mask)
        return table, OpResult(ok=ok, ledger=ctr)

    def lookup(self, table, keys) -> OpResult:
        """One accounting path: the lookup emits its verb plan and the
        ledger is derived from the plan."""
        res = self._lookup_res(table, keys)
        plan = self._mod.lookup_plan(self.cfg, table, keys, res)
        return OpResult(ok=res.found, ledger=rv.ledger_from_plan(plan),
                        values=res.values, reads=res.reads, plan=plan)

    def version_stamp(self, table, keys) -> torch.Tensor:
        return self._mod.version_stamp(self.cfg, table, keys)

    def version_read_plan(self, table, keys):
        """Verb plan pricing ONE stamp-validation batch."""
        return self._mod.version_read_plan(self.cfg, table, keys)

    def load_factor(self, table) -> torch.Tensor:
        return self._mod.load_factor(self.cfg, table)

    def stats(self, table) -> dict:
        """Host-side diagnostics (waits for the device)."""
        return {
            "scheme": self.name,
            "count": int(table.count),
            "total_slots": float(self.total_slots(table)),
            "load_factor": float(self.load_factor(table)),
        }


@dataclasses.dataclass(frozen=True)
class ContinuityStore(_ModuleStore):
    """The paper's continuity hashing behind the protocol.

    ``policy.probe``: ``kernel`` -> the segment-probe kernel wrapper
    (`repro_torch.kernels.ops.probe_lookup`), ``reference`` -> its plain
    version, ``gather`` -> ``continuity.lookup``; fingerprint pre-filter
    per ``policy.use_fp``.  ``policy.mutate`` picks the match backend of
    the fused update/delete the same way.  ``policy.engine="serial"``
    raises: the serial oracles are not ported yet."""

    cfg: ch.ContinuityConfig = ch.ContinuityConfig(num_buckets=256)
    name: ClassVar[str] = "continuity"

    @property
    def _mod(self):
        return ch

    def _check_engine(self):
        if self.policy.engine == "serial":
            raise NotImplementedError(
                "engine='serial' needs the serial oracles (insert_serial/"
                "update_serial/delete_serial), not yet ported: ROADMAP.md "
                "Queue 1, item 3")

    def _insert_fn(self):
        self._check_engine()
        return ch.insert

    def _update_fn(self):
        self._check_engine()
        return functools.partial(ch.update, probe=self.policy.mutate)

    def _delete_fn(self):
        self._check_engine()
        return functools.partial(ch.delete, probe=self.policy.mutate)

    def _lookup_res(self, table, keys):
        if self.policy.probe == "gather":
            return ch.lookup(self.cfg, table, keys)
        from repro_torch.kernels import ops as K
        return K.probe_lookup(self.cfg, table, keys,
                              use_kernel=self.policy.probe == "kernel",
                              use_fp=self.policy.use_fp)

    def total_slots(self, table=None) -> float:
        if table is None:
            return float(self.cfg.num_pairs * self.cfg.slots_per_pair)
        return float(ch.capacity(self.cfg, table))

    def stats(self, table) -> dict:
        out = super().stats(table)
        out["ext_groups"] = int(table.ext_count)
        return out

    @classmethod
    def from_slots(cls, table_slots: int, policy: ExecPolicy = ExecPolicy(),
                   device: str = "cuda", **overrides) -> "ContinuityStore":
        per_pair = ch.ContinuityConfig(2).slots_per_pair
        pairs = max(2, -(-table_slots // per_pair))   # ceil: >= table_slots
        # a 1/8 stash tier by default, as the reference's factory
        overrides.setdefault("stash_frac", 1 / 8)
        cfg = dataclasses.replace(
            ch.ContinuityConfig(num_buckets=2 * pairs), **overrides)
        return cls(cfg=cfg, policy=policy, device=device)


def _register_builtin(registry_register) -> None:
    registry_register(ContinuityStore.name, ContinuityStore.from_slots)
