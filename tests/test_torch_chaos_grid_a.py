"""The port's chaos matrix (`repro_torch.chaos`) against the JAX
package's, on the CPU: the first half of `matrix.GRID`.

Each half of the grid runs at seed 0 with the ``smoke`` profile, its
cells in the matrix's order and at the matrix's seeds (``seed * 1000 +
i``), under one deterministic `TickClock` tracer per package, as
``python -m repro.chaos.matrix --trace`` runs them.  Every cell's payload
(checks, chaos counts, wire totals, events, ``ops_per_s``) equals the
reference's, field for field, and so does the half's trace and metrics
export, byte for byte.  The second half is in
``tests/test_torch_chaos_grid_b.py``; the port's own matrix on seeds 1-3
and its ``--trace`` export under ``repro_torch.obs.report --check`` in
``tests/test_torch_chaos_matrix.py``.
"""

import pytest

from repro import obs as jobs
from repro.chaos import matrix as jmatrix
from repro.chaos import scenarios as jscen
from repro_torch import obs
from repro_torch.chaos import matrix, scenarios
from test_torch_cluster import assert_same

HALF = len(matrix.GRID) // 2


def traced_cells(lo: int, hi: int):
    """(reference, port): each ``(cells, trace_json, metrics_json)`` of the
    grid's cells ``lo:hi`` at seed 0, traced under one `TickClock`."""
    out = []
    for o, scen, kw in ((jobs, jscen, {}), (obs, scenarios,
                                            {"device": "cpu"})):
        with o.scope(o.Tracer(o.TickClock())) as (tracer, reg):
            cells = [scen.run_scenario(name, workload=wl, seed=i,
                                       profile="smoke", **kw)
                     for i, (name, wl) in enumerate(matrix.GRID)
                     if lo <= i < hi]
            out.append((cells, *o.export_strings(
                tracer, reg, meta={"cells": [lo, hi]})))
    return out


@pytest.fixture(scope="module")
def half():
    return traced_cells(0, HALF)


def test_grid_and_sizes_are_the_references():
    assert matrix.GRID == jmatrix.GRID and len(matrix.GRID) == 14
    assert scenarios.SIZES == jscen.SIZES
    assert list(scenarios.SCENARIOS) == list(jscen.SCENARIOS)


@pytest.mark.parametrize("i", range(HALF),
                         ids=[f"{n}-{w}" for n, w in matrix.GRID[:HALF]])
def test_cell_equals_reference(half, i):
    (ref, _, _), (port, _, _) = half
    assert_same(ref[i], port[i])
    assert port[i]["ok"], port[i]["checks"]
    assert port[i]["committed_lost"] == 0


def test_half_grid_export_is_byte_identical(half):
    (_, jt, jm), (_, t, m) = half
    assert t == jt and m == jm
