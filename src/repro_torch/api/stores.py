"""Registered `HashStore` adapters for the four built-in schemes.

Port of ``repro.api.stores``.  Each store is a frozen dataclass binding a
scheme module's functions to the protocol's calling convention, the unified
`OpResult`/`CostLedger`, an `ExecPolicy` and the device its tables live
on.  Write ops update the table in place and return it.

  * ``continuity`` — the paper's scheme (segment-probe and mutation-plan
    kernels behind ``policy.probe`` / ``policy.mutate``);
  * ``level``  — Level hashing (OSDI'18), the paper's PM-friendly baseline;
  * ``pfarm``  — P-FaRM-KV (FaRM-KV x RECIPE), the paper's RDMA baseline;
  * ``dense``  — the dense block-table reference.

Factories size the table to ``table_slots`` storage units as the
reference's do, so cross-scheme numbers compare at equal capacity.  Resize
and the crash-consistency surface are not ported yet: those methods raise
``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, ClassVar, Tuple

import torch

from repro_torch.api.types import ExecPolicy, OpResult
from repro_torch.core import continuity as ch
from repro_torch.core import dense as dn
from repro_torch.core import level as lv
from repro_torch.core import pfarm as pf
from repro_torch.core.continuity import KEY_LANES, VAL_LANES
from repro_torch.rdma import verbs as rv

_RESIZE = ("resize is not ported yet: ROADMAP.md Queue 1, item 5 (resize / "
           "split)")
_CRASH = ("the crash-consistency surface is not ported yet: ROADMAP.md "
          "Queue 1, item 8")


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

    def _extract(self, table):
        """(keys, vals, live_mask) of every storage slot."""
        raise NotImplementedError

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

    def scan_plan(self, table, keys, spans):
        """Verb plan of a YCSB-E short-scan batch: ``spans[i]`` records
        read from ``keys[i]``'s position (continuity: one contiguous READ
        per scan; the scattered baselines: one READ per record)."""
        return self._mod.scan_plan(self.cfg, table, keys, spans)

    def version_stamp(self, table, keys) -> torch.Tensor:
        """(B, S) int32 stamp per key: ``[found, value words]`` (continuity
        overrides it with its 8-byte indicator word)."""
        res = self._lookup_res(table, keys)
        return torch.cat([res.found[:, None].to(torch.int32), res.values], -1)

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

    # -- surfaces not ported yet ---------------------------------------------
    def begin_resize(self, table, factor: int = 2, step_slo_us=None):
        raise NotImplementedError(_RESIZE)

    def resize_step(self, state, budget=None):
        raise NotImplementedError(_RESIZE)

    def resize_cutover(self, state):
        raise NotImplementedError(_RESIZE)

    def resize(self, table, factor: int = 2):
        raise NotImplementedError(_RESIZE)

    def trace_insert(self, table, keys, vals, mask=None):
        raise NotImplementedError(_CRASH)

    def trace_update(self, table, keys, vals, mask=None):
        raise NotImplementedError(_CRASH)

    def trace_delete(self, table, keys, mask=None):
        raise NotImplementedError(_CRASH)

    def recover(self, table_or_state):
        raise NotImplementedError(_CRASH)


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

    def version_stamp(self, table, keys) -> torch.Tensor:
        """(B, 2) ``[version, indicator]`` of each key's pair: the ONE
        8-byte word every committed mutation on the pair rewrites."""
        return ch.version_stamp(self.cfg, table, keys)

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


def _token_mask(tok: torch.Tensor, bucket_slots: int) -> torch.Tensor:
    """(N * bs,) bool: the valid bit of every slot, bucket-major."""
    return (lv.token_bits(tok, bucket_slots) == 1).reshape(-1)


@dataclasses.dataclass(frozen=True)
class LevelStore(_ModuleStore):
    """Level hashing baseline: writes walk the batch in order (the
    serial-walk kernel); ``policy`` knobs other than ``transport`` do not
    apply."""

    cfg: lv.LevelConfig = lv.LevelConfig(num_top=64)
    name: ClassVar[str] = "level"

    @property
    def _mod(self):
        return lv

    def _extract(self, table):
        keys = torch.cat([table.tkeys.reshape(-1, KEY_LANES),
                          table.bkeys.reshape(-1, KEY_LANES)])
        vals = torch.cat([table.tvals.reshape(-1, VAL_LANES),
                          table.bvals.reshape(-1, VAL_LANES)])
        live = torch.cat([_token_mask(table.ttok, self.cfg.bucket_slots),
                          _token_mask(table.btok, self.cfg.bucket_slots)])
        return keys, vals, live

    def total_slots(self, table=None) -> float:
        return float(self.cfg.total_slots)

    @classmethod
    def from_slots(cls, table_slots: int, policy: ExecPolicy = ExecPolicy(),
                   device: str = "cuda", **overrides) -> "LevelStore":
        top = int(table_slots / 1.5 / 4)
        cfg = dataclasses.replace(
            lv.LevelConfig(num_top=top + top % 2), **overrides)
        return cls(cfg=cfg, policy=policy, device=device)


@dataclasses.dataclass(frozen=True)
class PFarmStore(_ModuleStore):
    """P-FaRM-KV baseline (RECIPE logging: 5 PM writes per mutation);
    writes walk the batch in order (the serial-walk kernel)."""

    cfg: pf.PFarmConfig = pf.PFarmConfig(num_buckets=64)
    name: ClassVar[str] = "pfarm"

    @property
    def _mod(self):
        return pf

    def _extract(self, table):
        keys = torch.cat([table.keys.reshape(-1, KEY_LANES),
                          table.okeys.reshape(-1, KEY_LANES)])
        vals = torch.cat([table.vals.reshape(-1, VAL_LANES),
                          table.ovals.reshape(-1, VAL_LANES)])
        live = torch.cat([_token_mask(table.tok, self.cfg.bucket_slots),
                          _token_mask(table.otok, self.cfg.bucket_slots)])
        return keys, vals, live

    def total_slots(self, table=None) -> float:
        return float(self.cfg.total_slots)

    @classmethod
    def from_slots(cls, table_slots: int, policy: ExecPolicy = ExecPolicy(),
                   device: str = "cuda", **overrides) -> "PFarmStore":
        cfg = dataclasses.replace(
            pf.PFarmConfig(num_buckets=int(table_slots / 1.25 / 4)),
            **overrides)
        return cls(cfg=cfg, policy=policy, device=device)


@dataclasses.dataclass(frozen=True)
class DenseStore(_ModuleStore):
    """Dense block-table reference (no hashing; whole-table lookups)."""

    cfg: dn.DenseConfig = dn.DenseConfig(capacity=256)
    name: ClassVar[str] = "dense"

    @property
    def _mod(self):
        return dn

    def _extract(self, table):
        return dn.extract_items(self.cfg, table)

    def total_slots(self, table=None) -> float:
        return float(self.cfg.capacity)

    @classmethod
    def from_slots(cls, table_slots: int, policy: ExecPolicy = ExecPolicy(),
                   device: str = "cuda", **overrides) -> "DenseStore":
        cfg = dataclasses.replace(dn.DenseConfig(capacity=table_slots),
                                  **overrides)
        return cls(cfg=cfg, policy=policy, device=device)


def _register_builtin(registry_register) -> None:
    for cls in (ContinuityStore, LevelStore, PFarmStore, DenseStore):
        registry_register(cls.name, cls.from_slots)
