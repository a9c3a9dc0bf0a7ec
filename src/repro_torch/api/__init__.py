"""`repro_torch.api` — the hash-store interface of the PyTorch port.

    from repro_torch import api

    store = api.make_store("level", table_slots=4096)   # tables on cuda
    table = store.create()
    table, res = store.insert(table, keys, vals)
    hits = store.lookup(table, keys)
    print(res.ledger.pm_per_op(), hits.ledger.reads_per_op())

Pass ``device="cpu"`` to ``make_store`` to run on the CPU; asking for CUDA
where there is none raises.
"""

from repro_torch.api.registry import (available_schemes, get_scheme,
                                      make_store, register_scheme)
from repro_torch.api.stores import (ContinuityStore, DenseStore, LevelStore,
                                    PFarmStore, _register_builtin)
from repro_torch.api.types import CostLedger, ExecPolicy, HashStore, OpResult

_register_builtin(register_scheme)

__all__ = [
    "available_schemes", "get_scheme", "make_store", "register_scheme",
    "ContinuityStore", "LevelStore", "PFarmStore", "DenseStore",
    "CostLedger", "ExecPolicy", "HashStore", "OpResult",
]
