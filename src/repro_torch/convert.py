"""Carry tables, model parameters and paged caches between numpy arrays and
the port's tensors.

Table fields are keyed by the ``ContinuityTable`` field names.  The
reference's uint32 fields map bit for bit onto the port's int32 storage;
``ext_map``, ``ext_count`` and ``count`` are int32 on both sides.  A table
built elsewhere (for example by the JAX package, through ``np.asarray`` of
each field) loads with ``table_from_numpy``, and ``table_to_numpy`` gives
arrays that compare field by field with the reference's.

``params_from_numpy`` maps the reference's parameter tree (as numpy, same
keys, per-layer tensors stacked on L) onto the port's storage dtypes;
``cache_from_numpy``/``cache_to_numpy`` carry a ``PagedCache``, its
per-shard page tables stacked on a leading DS dim as in the reference.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.continuity import ContinuityTable
from repro_torch.core.words import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.kvcache import PagedCache

INT32_FIELDS = ("ext_map", "ext_count", "count")
F32_LEAVES = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
              "final_scale", "final_bias", "lm_head")


def table_from_numpy(fields: Mapping[str, np.ndarray],
                     device="cuda") -> ContinuityTable:
    """Build a port table on ``device`` from numpy arrays."""
    dev = resolve_device(device)
    missing = set(ContinuityTable._fields) - set(fields)
    if missing:
        raise ValueError(f"missing table fields: {sorted(missing)}")
    out = {}
    for name in ContinuityTable._fields:
        a = np.asarray(fields[name])
        want = np.int32 if name in INT32_FIELDS else np.uint32
        if a.dtype != want:
            raise ValueError(f"field {name} must be {np.dtype(want)}, "
                             f"got {a.dtype}")
        # np.array keeps 0-d fields 0-d (ascontiguousarray would not)
        out[name] = torch.from_numpy(
            np.array(a, order="C").view(np.int32)).to(dev)
    return ContinuityTable(**out)


def table_to_numpy(table: ContinuityTable) -> dict:
    """Copy a port table to host numpy arrays in the reference's dtypes."""
    out = {}
    for name in ContinuityTable._fields:
        a = getattr(table, name).detach().cpu().numpy().copy()
        out[name] = a if name in INT32_FIELDS else a.view(np.uint32)
    return out


def params_from_numpy(params_np: Mapping, cfg, device="cuda") -> dict:
    """The reference's parameter tree (numpy leaves) as the port's: the
    matrices the reference casts to ``cfg.dtype`` at every use are stored
    in it, norm scales and the LM head in float32."""
    dev = resolve_device(device)

    def leaf(name, a):
        if name in F32_LEAVES:
            dt = torch.float32
        elif name == "embed":
            dt = T.embed_dtype(cfg)
        elif name in T.CAST_LEAVES:
            dt = T._dtype(cfg)
        else:
            raise NotImplementedError(
                f"parameter {name!r} belongs to a family not ported yet")
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dt)

    out = {k: leaf(k, v) for k, v in params_np.items() if k != "blocks"}
    out["blocks"] = {k: leaf(k, v) for k, v in params_np["blocks"].items()}
    return out


def cache_from_numpy(fields: Mapping, device="cuda") -> PagedCache:
    """A paged cache on ``device`` from numpy arrays: the ``PagedCache``
    fields, ``table`` a mapping of table fields with a leading DS dim."""
    dev = resolve_device(device)
    tab = fields["table"]
    DS = np.asarray(tab["count"]).shape[0]
    tables = tuple(table_from_numpy({k: np.asarray(v)[s] for k, v in
                                     tab.items()}, dev) for s in range(DS))
    out = {"table": tables}
    for name in PagedCache._fields:
        if name == "table":
            continue
        a = np.asarray(fields[name])
        if name in ("kpool", "vpool"):
            out[name] = torch.from_numpy(np.array(a, np.float32)).to(
                dev, getattr(torch, str(a.dtype)))
        else:       # int32 words (seq_ids: the reference's uint32 bits)
            out[name] = torch.from_numpy(
                np.array(a, order="C").view(np.int32)).to(dev)
    return PagedCache(**out)


def cache_to_numpy(cache: PagedCache) -> dict:
    """A paged cache as host numpy arrays in the reference's dtypes (pools
    as float32 values); ``table`` holds each table field stacked on DS."""
    tabs = [table_to_numpy(t) for t in cache.table]
    out = {"table": {k: np.stack([t[k] for t in tabs]) for k in tabs[0]}}
    for name in PagedCache._fields:
        if name == "table":
            continue
        t = getattr(cache, name).detach().cpu()
        if name in ("kpool", "vpool"):
            out[name] = t.to(torch.float32).numpy().copy()
        else:
            a = t.numpy().copy()
            out[name] = a.view(np.uint32) if name == "seq_ids" else a
    return out
