"""Serial-walk kernel: the level and P-FaRM-KV write paths in batch order,
and the distributed continuity store's routed writes in the order received.

No TPU kernel is replaced: the reference runs these write paths as a
``jax.lax.scan`` over the batch (``src/repro/core/level.py:344``, ``:354``,
``:363``; ``src/repro/core/pfarm.py:352``, ``:362``, ``:371``;
``src/repro/core/distributed.py:266``).  The CUDA
kernel in ``csrc/scan_walk.cu`` walks the batch in order, one op at a time,
with a warp's lanes over the op's candidate slots, and takes the branch the
reference takes (level: plain or one-movement insert, free or logged
update; pfarm: plain, one displacement or a chain block; continuity's
routed entries: insert, update or delete on the entry's segment).  The table
updates in place; ``count`` (and pfarm's ``ocount``) in device memory.

Bound: latency, one dependent random trip to device memory per op (the
candidate buckets' token bytes).  ``chase`` measures that floor on the
card: a dependent chain of random single-byte loads over an array.

``walk`` is how a level or pfarm write batch reaches the kernel (the
batch's words normalized, the ledger summed); ``scan_walk`` is the
kernel's wrapper.  On a CPU tensor the wrappers run the plain versions
(``scan_walk_ref``); on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.core import pmem
from repro_torch.core.words import batch_words
from repro_torch.kernels import _cuda
from repro_torch.kernels.scan_walk_ref import (chase_ref, routed_write_ref,
                                               scan_walk_ref)


def walk(scheme: str, op: str, cfg, t, keys, vals, mask):
    """A level or pfarm write batch through the serial walk, in place:
    ``(table, ok, ledger)``, the ledger counting active ops as the
    reference's ``_scan`` does."""
    keys, vals, active = batch_words(t[0].device, keys, vals, mask)
    ok, pm = scan_walk(scheme, op, cfg, t, keys, vals, active)
    ctr = pmem.CostLedger.zero(keys.device).add(pm_writes=pm.sum(),
                                                ops=active.sum())
    return t, ok.bool(), ctr


def scan_walk(scheme: str, op: str, cfg, table, keys, vals, active):
    """Apply a write batch of ``scheme`` ("level" or "pfarm") and ``op``
    ("insert", "update", "delete") to ``table`` in place, in batch order.

    ``keys``/``vals`` are (B, 4) int32 words (``vals`` None for delete),
    ``active`` (B,) bool.  Returns ``(ok, pm)``: (B,) int32, ``ok`` 1 where
    the op succeeded, ``pm`` the PM writes it charged.
    """
    if keys.device.type == "cpu":
        return scan_walk_ref(scheme, op, cfg, table, keys, vals, active)
    out = _cuda.launch_scan_walk(scheme, op, cfg, table, keys, vals, active)
    if keys.shape[0]:             # an empty batch launches nothing
        scan_walk.launches += 1
    return out


scan_walk.launches = 0   # kernel launches since the last reset


def routed_write(cfg, table, pair, parity, op, keys, vals, live):
    """Apply the routed write entries of the distributed store
    (``core.distributed``) to the local ext-free continuity ``table`` in
    place, one at a time in order: entry ``i`` is op ``op[i]`` (1 insert,
    2 update, 3 delete) of key ``keys[i]`` / value ``vals[i]`` (4 int32
    words each) at local pair ``pair[i]`` with home parity ``parity[i]``,
    applied where ``live[i]``.  Returns the (N,) int32 status (1 =
    applied).  Counted in ``scan_walk.launches``."""
    if keys.device.type == "cpu":
        return routed_write_ref(cfg, table, pair, parity, op, keys, vals,
                                live)
    if keys.device.type == "meta":      # shapes only (launch.dryrun)
        return torch.empty(keys.shape[0], dtype=torch.int32, device="meta")
    out, _ = _cuda.launch_scan_walk("continuity", "routed", cfg, table, keys,
                                    vals, live, route=(pair, parity, op))
    if keys.shape[0]:
        scan_walk.launches += 1
    return out


def chase(data: torch.Tensor, elem: int, steps: int, seed: int) -> torch.Tensor:
    """The walk's latency floor: ``steps`` dependent random single-byte loads
    from the ``len(data) // elem`` elements of the uint8 array ``data``
    (element ``(h * n) >> 32`` for a 32-bit state ``h`` that each loaded
    byte feeds), one warp, each load waiting for the one before.  Returns
    the final state, a (1,) int32 tensor holding its uint32 bits, so the
    card is held to the plain version.  Not on any write path: it measures
    what one op's dependent trip costs (``chip_smoke.py``)."""
    if data.device.type == "cpu":
        return chase_ref(data, elem, steps, seed)
    return _cuda.launch_scan_walk_chase(data, elem, steps, seed)
