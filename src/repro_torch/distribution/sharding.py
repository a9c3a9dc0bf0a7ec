"""Logical-axis sharding: rules mapping logical dims to mesh axes.

Port of ``repro.distribution.sharding`` onto ``torch.distributed``'s
``DeviceMesh`` and DTensor.  Models annotate tensors with LOGICAL names
("batch", "heads", "mlp", ...); a rules table maps each name to physical
mesh axes.  ``logical_spec`` gives the counterpart of the reference's
``PartitionSpec``: per dim, ``None`` (replicated), one mesh-axis name, or
a tuple of names (a dim sharded over several axes, major first).
``placements`` turns such a spec into DTensor placements, a dim sharded
over two mesh axes becoming ``Shard(d)`` on each of them (DTensor shards
over mesh dims left to right, JAX's major-to-minor order).

``shard`` is the identity with no mesh, so every single-device caller sees
the same tensors.  Under ``use_mesh`` it is the counterpart of
``with_sharding_constraint``: a DTensor is redistributed to the spec's
placements, a plain tensor (the same on every rank) becomes a DTensor
with them.  Changing a rules entry changes every annotated placement
without touching model code.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import torch

_state = threading.local()

# Default rules for the production meshes: DP over (pod, data); TP over model.
# kv_heads / experts map to model only when divisible (checked at use site).
DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": None,
    "vocab": ("model",),
    "layers": None,
    "ssm_inner": None,
    "ssm_heads": ("model",),
    "kv_pairs": ("data",),        # the continuity table's pair dim
    "zero": ("data",),            # ZeRO-1 moment sharding
    # decode-time KV layout: pools shard over (pod, data); page tokens split
    # over model ("split-KV" — works for any kv-head count); kv heads at
    # decode stay replicated (the split-KV axis carries the parallelism)
    "kv_shard": ("pod", "data"),
    "page_tokens": ("model",),
    "kv_heads_dec": None,
}


def set_mesh_and_rules(mesh, rules: Optional[dict] = None):
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES, **(rules or {}))


def get_mesh():
    return getattr(_state, "mesh", None)


def get_rules() -> dict:
    # the reference returns the None that ``use_mesh`` restores on exit;
    # the defaults stand in for it here
    return getattr(_state, "rules", None) or DEFAULT_RULES


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Make ``mesh`` (a ``DeviceMesh`` with named dims) and ``rules`` the
    active ones for this thread inside the block."""
    old = get_mesh(), getattr(_state, "rules", None)
    set_mesh_and_rules(mesh, rules)
    try:
        yield
    finally:
        _state.mesh, _state.rules = old


def axis_sizes(mesh) -> Dict[str, int]:
    """{mesh-axis name: extent} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def logical_spec(*names: Optional[str], size_of=None) -> tuple:
    """Per-dim mesh axes from logical dim names under the active rules:
    ``None``, an axis name, or a tuple of axis names.

    ``size_of``: optional tuple of dim sizes; a logical axis whose dim size
    is not divisible by its mesh-axes extent degrades to replicated (the
    GQA kv_heads < TP case, or 40-expert MoE on a 16-way model axis).
    """
    mesh = get_mesh()
    rules = get_rules()
    sizes = axis_sizes(mesh) if mesh is not None else {}
    out = []
    for i, n in enumerate(names):
        axes = rules.get(n) if n else None
        if axes and mesh is not None:
            extent = 1
            for a in axes:
                extent *= sizes.get(a, 1)
            if size_of is not None and size_of[i] % max(extent, 1) != 0:
                out.append(None)
                continue
            axes = tuple(a for a in axes if a in sizes)
            out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
        else:
            out.append(None)
    return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements on ``mesh`` of a ``logical_spec``: ``Shard(d)`` on
    every mesh dim that shards tensor dim ``d``, ``Replicate()`` elsewhere
    and on a mesh dim of extent 1 (its one shard is the whole tensor;
    DTensor refuses to reshape a dim of size 1 sharded there)."""
    from torch.distributed.tensor import Replicate, Shard
    dims = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(dims)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            if sizes[a] > 1:
                out[dims.index(a)] = Shard(d)
    return tuple(out)


def chunk_of(entry, mesh) -> Tuple[int, int]:
    """(index, count) of this rank's chunk of a dim placed as one
    ``logical_spec`` entry (None, an axis name, or axis names, major first)
    on ``mesh``: the chunks in DTensor's order of ``placements``."""
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    sizes, names = axis_sizes(mesh), list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx, count = 0, 1
    for a in axes:
        idx = idx * sizes[a] + coord[names.index(a)]
        count *= sizes[a]
    return idx, count


def mesh_context():
    """Under a mesh, DTensor's ``implicit_replication`` (plain tensors made
    inside a step act as replicated); a null context without one."""
    if get_mesh() is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def to_placements(x, mesh, pl):
    """``x`` as a DTensor on ``mesh`` with placements ``pl``: a DTensor is
    redistributed (autograd flows through, and the backward brings the
    gradient back to ``x``'s placements, also where they were ``pl``
    already), a plain tensor, the same on every rank, is taken as
    replicated and cut locally."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x.redistribute(mesh, pl)
    rep = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, pl)


def shard(x, *names: Optional[str]):
    """Constrain ``x``'s sharding by logical dim names (identity w/o mesh)."""
    mesh = get_mesh()
    if mesh is None:
        return x
    spec = logical_spec(*names, size_of=tuple(x.shape))
    return to_placements(x, mesh, placements(spec, mesh))


def named_sharding(*names: Optional[str], size_of=None):
    """The placements of ``names`` on the active mesh; ``None`` without one."""
    mesh = get_mesh()
    if mesh is None:
        return None
    return placements(logical_spec(*names, size_of=size_of), mesh)


def distribute(tree, axes_tree):
    """Each leaf of the nested dicts ``tree`` as a DTensor on the active
    mesh, placed by its logical axes in ``axes_tree`` (the same structure;
    ``None`` or ``()`` replicates)."""
    mesh = get_mesh()
    if isinstance(tree, dict):
        return {k: distribute(v, axes_tree[k]) for k, v in tree.items()}
    if tree is None or mesh is None:
        return tree
    names = tuple(axes_tree) if axes_tree else (None,) * tree.dim()
    spec = logical_spec(*names, size_of=tuple(tree.shape))
    return to_placements(tree, mesh, placements(spec, mesh))


def gather(tree):
    """The full tensors of a tree of DTensors (plain leaves as they are)."""
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and is_dtensor(tree):
        return tree.full_tensor()
    return tree
