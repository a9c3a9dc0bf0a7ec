"""Carry continuity tables between numpy arrays and the port's tensors.

Fields are keyed by the ``ContinuityTable`` field names.  The reference's
uint32 fields map bit for bit onto the port's int32 storage; ``ext_map``,
``ext_count`` and ``count`` are int32 on both sides.  A table built
elsewhere (for example by the JAX package, through ``np.asarray`` of each
field) loads with ``table_from_numpy``, and ``table_to_numpy`` gives
arrays that compare field by field with the reference's.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.continuity import ContinuityTable
from repro_torch.core.words import resolve_device

INT32_FIELDS = ("ext_map", "ext_count", "count")


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
