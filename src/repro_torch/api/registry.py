"""Scheme registry: one name -> store-factory map.

Port of ``repro.api.registry``.  A factory takes ``(table_slots, policy,
device, **overrides)`` and returns a store sized to roughly
``table_slots`` storage units.

    from repro_torch import api
    store = api.make_store("continuity", table_slots=4096)   # on cuda
    store = api.make_store("pfarm", device="cpu")            # tests

Registered: continuity, level, pfarm, dense (the reference's order).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.api.types import ExecPolicy, HashStore

_REGISTRY: Dict[str, Callable[..., HashStore]] = {}


def register_scheme(name: str, factory: Callable[..., HashStore],
                    *, overwrite: bool = False) -> None:
    """Register ``factory(table_slots, policy, device, **kw) -> store``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"scheme {name!r} already registered")
    _REGISTRY[name] = factory


def available_schemes() -> tuple:
    """All registered scheme names (deterministic registration order)."""
    return tuple(_REGISTRY)


def get_scheme(name: str) -> Callable[..., HashStore]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheme {name!r}; registered: {sorted(_REGISTRY)}") from None


def make_store(name: str, *, table_slots: int = 4096,
               policy: Optional[ExecPolicy] = None, device: str = "cuda",
               **overrides) -> HashStore:
    """Build a ready-to-use store for ``name`` whose tables live on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    return get_scheme(name)(table_slots, policy or ExecPolicy(), device,
                            **overrides)
