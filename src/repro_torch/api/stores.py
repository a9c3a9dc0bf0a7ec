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
reference's do, so cross-scheme numbers compare at equal capacity.

Every store also carries the maintenance protocol (``begin_resize`` /
``resize_step`` / ``resize_cutover``; continuity's is a cohort-at-a-time
online split) and the crash-consistency surface (``trace_*`` /
``recover``, through `repro_torch.consistency`).
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, ClassVar, Optional, Tuple

import torch

from repro_torch.api.types import ExecPolicy, OpResult, ResizeState
from repro_torch.core import continuity as ch
from repro_torch.core import dense as dn
from repro_torch.core import level as lv
from repro_torch.core import pfarm as pf
from repro_torch.core.continuity import KEY_LANES, VAL_LANES
from repro_torch.core.words import as_words
from repro_torch.rdma import verbs as rv


def _check_resize_lossless(name: str, old_table, new_table) -> None:
    lost = int(old_table.count) - int(new_table.count)
    if lost:
        raise RuntimeError(
            f"resize dropped {lost} live item(s) from the {name!r} store "
            f"({int(old_table.count)} -> {int(new_table.count)}); grow by a "
            f"larger factor or rehash manually")


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

    # -- incremental maintenance surface ------------------------------------
    # The generic implementation completes the whole rehash in the FIRST
    # step (a stop-the-world move is all the scattered baselines can offer:
    # their candidate buckets change wholesale at the new size); continuity
    # overrides the triple with a real cohort-at-a-time split.

    def begin_resize(self, table, factor: int = 2,
                     step_slo_us: Optional[float] = None) -> ResizeState:
        # the baselines cannot increment (their first step moves
        # everything), so a stall SLO is accepted and unsatisfiable
        new = dataclasses.replace(self, cfg=self.cfg.grow(factor))
        return ResizeState(store=self, new_store=new, table=table,
                           new_table=new.create(), factor=factor,
                           n_items=int(table.count))

    def resize_step(self, state: ResizeState,
                    budget: Optional[int] = None) -> ResizeState:
        if state.done:
            return state
        # into a fresh grown table, not ``state.new_table``: the port's
        # inserts update their table in place, so a step replayed from the
        # begin handle would otherwise insert every item a second time
        keys, vals, live = self._extract(state.table)
        new_table, _ = state.new_store.insert(state.new_store.create(), keys,
                                              vals, live)
        return dataclasses.replace(state, new_table=new_table, done=True,
                                   moved=int(live.sum()))

    def resize_cutover(self, state: ResizeState) -> Tuple["_ModuleStore", Any]:
        """Finish any remaining steps and hand over the grown store.

        Raises if any live item failed to reinsert (possible for the
        bucketed baselines when candidate buckets collide even at the
        larger size) instead of dropping it."""
        while not state.done:
            state = self.resize_step(state, budget=1 << 30)
        _check_resize_lossless(self.name, state.table, state.new_table)
        return state.new_store, state.new_table

    def resize(self, table, factor: int = 2) -> Tuple["_ModuleStore", Any]:
        """DEPRECATED one-shot resize: begin + step-to-completion + cutover.

        New code drives ``begin_resize``/``resize_step`` from its
        maintenance loop and ``resize_cutover`` when the split has
        drained."""
        warnings.warn(
            "HashStore.resize() is deprecated; use begin_resize()/"
            "resize_step()/resize_cutover()", DeprecationWarning,
            stacklevel=2)
        return self.resize_cutover(self.begin_resize(table, factor))

    # -- crash-consistency surface (repro_torch.consistency) ----------------
    # Traced twins of the write ops: the same table update (in place) and
    # ok flags, plus the ordered PM store trace the crash injector replays.
    # ``recover`` is the scheme's restart procedure; it accepts a table or
    # a crash-injected state (`CrashState.state`) and returns a new table.

    def trace_insert(self, table, keys, vals, mask=None):
        from repro_torch import consistency
        return consistency.trace_store_op(self, table, "insert", keys, vals,
                                          mask)

    def trace_update(self, table, keys, vals, mask=None):
        from repro_torch import consistency
        return consistency.trace_store_op(self, table, "update", keys, vals,
                                          mask)

    def trace_delete(self, table, keys, mask=None):
        from repro_torch import consistency
        return consistency.trace_store_op(self, table, "delete", keys, None,
                                          mask)

    def recover(self, table_or_state):
        from repro_torch import consistency
        return consistency.recover_store(self, table_or_state)


@dataclasses.dataclass(frozen=True)
class ContinuityStore(_ModuleStore):
    """The paper's continuity hashing behind the protocol.

    ``policy.probe``: ``kernel`` -> the segment-probe kernel wrapper
    (`repro_torch.kernels.ops.probe_lookup`), ``reference`` -> its plain
    version, ``gather`` -> ``continuity.lookup``; fingerprint pre-filter
    per ``policy.use_fp``.  ``policy.mutate`` picks the match backend of
    the fused update/delete the same way.  ``policy.engine="serial"``
    runs the serial oracles (one op at a time, byte-identical)."""

    cfg: ch.ContinuityConfig = ch.ContinuityConfig(num_buckets=256)
    name: ClassVar[str] = "continuity"

    @property
    def _mod(self):
        return ch

    def _insert_fn(self):
        return ch.insert_serial if self.policy.engine == "serial" else ch.insert

    def _update_fn(self):
        if self.policy.engine == "serial":
            return ch.update_serial
        return functools.partial(ch.update, probe=self.policy.mutate)

    def _delete_fn(self):
        if self.policy.engine == "serial":
            return ch.delete_serial
        return functools.partial(ch.delete, probe=self.policy.mutate)

    def _lookup_res(self, table, keys):
        if self.policy.probe == "gather":
            return ch.lookup(self.cfg, table, keys)
        from repro_torch.kernels import ops as K
        return K.probe_lookup(self.cfg, table, keys,
                              use_kernel=self.policy.probe == "kernel",
                              use_fp=self.policy.use_fp)

    def _extract(self, table):
        return ch.extract_items(self.cfg, table)

    def version_stamp(self, table, keys) -> torch.Tensor:
        """(B, 2) ``[version, indicator]`` of each key's pair: the ONE
        8-byte word every committed mutation on the pair rewrites."""
        return ch.version_stamp(self.cfg, table, keys)

    def begin_resize(self, table, factor: int = 2,
                     step_slo_us: Optional[float] = None) -> ResizeState:
        # the paper's log-free resize as an ONLINE split: per-pair cutover
        # tokens route traffic while cohorts move one at a time
        new_cfg, new_table, split = ch.split_begin(self.cfg, table, factor)
        step_budget = None
        if step_slo_us is not None:
            # cohorts per step = how many single-cohort moves fit in the
            # stall budget under the LinkModel (each reads one source row
            # and writes its items, words and the cutover token); >= 1
            from repro_torch.rdma.transport import LinkModel
            per = LinkModel().cohort_move_us(
                read_bytes=float(self.cfg.row_bytes),
                write_bytes=float(self.cfg.row_bytes + 16))
            step_budget = max(1, int(step_slo_us / per))
        return ResizeState(
            store=self, new_store=dataclasses.replace(self, cfg=new_cfg),
            table=table, new_table=new_table, factor=factor, opaque=split,
            n_items=int(table.count), step_budget=step_budget)

    def resize_step(self, state: ResizeState,
                    budget: Optional[int] = None) -> ResizeState:
        if state.done:
            return state
        if budget is None:
            budget = state.step_budget or 1
        table, new_table, split, moved = ch.split_step(
            self.cfg, state.table, state.new_store.cfg, state.new_table,
            state.opaque, budget)
        return dataclasses.replace(
            state, table=table, new_table=new_table, opaque=split,
            moved=state.moved + moved, done=ch.split_done(self.cfg, split))

    def resize_cutover(self, state: ResizeState):
        while not state.done:
            state = self.resize_step(state, budget=self.cfg.num_pairs)
        left = int(state.table.count)
        if left:
            raise RuntimeError(
                f"resize cutover with {left} item(s) still in the source "
                f"{self.name!r} table — the split did not drain")
        return state.new_store, state.new_table

    def recover(self, table_or_state):
        """The restart procedure (`continuity.restart`) on the store's
        device, of a table or of a crash-injected numpy state."""
        from repro_torch.consistency.schemes import HANDLERS
        h = HANDLERS[self.name]
        table = h.state_to_table(self.cfg, h.init_state(
            self.cfg, table_or_state), self.device) if isinstance(
                table_or_state, dict) else table_or_state
        return h.restart_table(self.cfg, table)

    # -- mid-split routing (the maintenance loop's read/write path) ---------
    def resize_lookup(self, state: ResizeState, keys) -> OpResult:
        """Dual read during a split: each key reads the table its cohort's
        cutover token names; the plan and ledger are the source table's
        lookup plan, as the reference's."""
        res = ch.split_lookup(self.cfg, state.table, state.new_store.cfg,
                              state.new_table, state.opaque, keys)
        plan = ch.lookup_plan(self.cfg, state.table, keys,
                              ch.lookup(self.cfg, state.table, keys))
        return OpResult(ok=res.found, ledger=rv.ledger_from_plan(plan),
                        values=res.values, reads=res.reads, plan=plan)

    def resize_write(self, state: ResizeState, op: str, keys, vals=None,
                     mask=None) -> Tuple[ResizeState, OpResult]:
        """Route one write batch by the split tokens: moved cohorts write
        the new table, unmoved the old (whose items the split will carry
        over).  Keeps insert-during-split lossless and duplicate-free."""
        keys = as_words(keys, KEY_LANES, state.opaque.token.device)
        to_new = ch.split_route(self.cfg, state.opaque, keys)
        m = (torch.ones_like(to_new) if mask is None else
             torch.as_tensor(mask, device=to_new.device).reshape(-1).bool())
        fn = {"insert": self.insert, "update": self.update,
              "delete": self.delete}[op]
        nfn = {"insert": state.new_store.insert,
               "update": state.new_store.update,
               "delete": state.new_store.delete}[op]
        args = (keys,) if op == "delete" else (keys, vals)
        table, r_old = fn(state.table, *args, mask=m & ~to_new)
        new_table, r_new = nfn(state.new_table, *args, mask=m & to_new)
        ok = torch.where(to_new, r_new.ok, r_old.ok)
        return (dataclasses.replace(state, table=table, new_table=new_table),
                OpResult(ok=ok, ledger=r_old.ledger.merge(r_new.ledger)))

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
