"""Shared check of the port's end-to-end YCSB simulator against the JAX
package's: one scheme x workload cell at the small size, both on the CPU,
equal key for key (floats to 1e-12 relative: the model is deterministic)."""

import pytest

from repro.rdma import sim as jsim
from repro_torch.rdma import sim

SMALL = dict(num_records=800, num_ops=1000, batch=250)


def assert_cell_matches(scheme: str, workload: str) -> dict:
    want = jsim.run_ycsb(scheme, workload, **SMALL)
    got = sim.run_ycsb(scheme, workload, device="cpu", **SMALL)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=1e-12, abs=0), k
    return got
