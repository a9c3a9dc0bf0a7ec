"""The port's ``rdma.sim.run_ycsb`` equals the JAX package's for the two
baselines (level, P-FaRM-KV) on every YCSB mix A-F, at 800 records, 1,000
ops and batches of 250, key for key.  Continuity's cells are in
``tests/test_torch_rdma.py``."""

import pytest

from _simparity import assert_cell_matches
from repro_torch.rdma import sim


@pytest.mark.parametrize("workload", sim.SIM_WORKLOADS)
@pytest.mark.parametrize("scheme", ["level", "pfarm"])
def test_run_ycsb_matches_reference(scheme, workload):
    assert_cell_matches(scheme, workload)
