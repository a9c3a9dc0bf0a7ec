"""Carry tables, model parameters and paged caches between numpy arrays and
the port's tensors.

Table fields are keyed by the table's field names.  The reference's uint32
fields map bit for bit onto the port's int32 storage; int32, uint8 (level
and pfarm tokens) and bool (dense ``live``) fields keep their dtype.  A
table built elsewhere (for example by the JAX package, through
``np.asarray`` of each field) loads with ``table_from_numpy`` (continuity),
``level_table_from_numpy``, ``pfarm_table_from_numpy`` or
``dense_table_from_numpy``, and the ``*_to_numpy`` functions give arrays
that compare field by field with the reference's.

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
from repro_torch.core.dense import DenseTable
from repro_torch.core.level import LevelTable
from repro_torch.core.pfarm import PFarmTable
from repro_torch.core.words import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.kvcache import PagedCache

INT32_FIELDS = ("ext_map", "ext_count", "count")
F32_LEAVES = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
              "final_scale", "final_bias", "lm_head")


def _from_numpy(cls, fields: Mapping[str, np.ndarray], device,
                dtypes: Mapping[str, type]):
    """A ``cls`` table on ``device``: uint32 fields (the default) become
    int32 words with the same bits, the fields in ``dtypes`` keep theirs."""
    dev = resolve_device(device)
    missing = set(cls._fields) - set(fields)
    if missing:
        raise ValueError(f"missing table fields: {sorted(missing)}")
    out = {}
    for name in cls._fields:
        a = np.asarray(fields[name])
        want = dtypes.get(name, np.uint32)
        if a.dtype != want:
            raise ValueError(f"field {name} must be {np.dtype(want)}, "
                             f"got {a.dtype}")
        # np.array keeps 0-d fields 0-d (ascontiguousarray would not)
        a = np.array(a, order="C")
        out[name] = torch.from_numpy(
            a.view(np.int32) if want == np.uint32 else a).to(dev)
    return cls(**out)


def _to_numpy(table, dtypes: Mapping[str, type]) -> dict:
    """A table's fields as host numpy arrays in the reference's dtypes."""
    out = {}
    for name in table._fields:
        a = getattr(table, name).detach().cpu().numpy().copy()
        out[name] = a.view(np.uint32) if name not in dtypes else a
    return out


_CONTINUITY = {name: np.int32 for name in INT32_FIELDS}
_LEVEL = {"ttok": np.uint8, "btok": np.uint8, "count": np.int32}
_PFARM = {"tok": np.uint8, "otok": np.uint8, "head": np.int32,
          "onext": np.int32, "ocount": np.int32, "count": np.int32}
_DENSE = {"live": np.bool_, "count": np.int32}


def table_from_numpy(fields: Mapping[str, np.ndarray],
                     device="cuda") -> ContinuityTable:
    """Build a continuity table on ``device`` from numpy arrays."""
    return _from_numpy(ContinuityTable, fields, device, _CONTINUITY)


def table_to_numpy(table: ContinuityTable) -> dict:
    """Copy a continuity table to host numpy arrays in the reference's
    dtypes."""
    return _to_numpy(table, _CONTINUITY)


def level_table_from_numpy(fields: Mapping[str, np.ndarray],
                           device="cuda") -> LevelTable:
    """Build a level table on ``device`` from numpy arrays."""
    return _from_numpy(LevelTable, fields, device, _LEVEL)


def level_table_to_numpy(table: LevelTable) -> dict:
    return _to_numpy(table, _LEVEL)


def pfarm_table_from_numpy(fields: Mapping[str, np.ndarray],
                           device="cuda") -> PFarmTable:
    """Build a P-FaRM-KV table on ``device`` from numpy arrays."""
    return _from_numpy(PFarmTable, fields, device, _PFARM)


def pfarm_table_to_numpy(table: PFarmTable) -> dict:
    return _to_numpy(table, _PFARM)


def dense_table_from_numpy(fields: Mapping[str, np.ndarray],
                           device="cuda") -> DenseTable:
    """Build a dense table on ``device`` from numpy arrays."""
    return _from_numpy(DenseTable, fields, device, _DENSE)


def dense_table_to_numpy(table: DenseTable) -> dict:
    return _to_numpy(table, _DENSE)


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
