"""The port's chaos matrix against the JAX package's, on the CPU: the
second half of `matrix.GRID` (the first half and the method:
``tests/test_torch_chaos_grid_a.py``).  Every cell's payload equals the
reference's field for field, and the half's traced export byte for byte.
"""

import pytest

from repro_torch.chaos import matrix
from test_torch_chaos_grid_a import HALF, traced_cells
from test_torch_cluster import assert_same


@pytest.fixture(scope="module")
def half():
    return traced_cells(HALF, len(matrix.GRID))


@pytest.mark.parametrize("i", range(len(matrix.GRID) - HALF),
                         ids=[f"{n}-{w}" for n, w in matrix.GRID[HALF:]])
def test_cell_equals_reference(half, i):
    (ref, _, _), (port, _, _) = half
    assert_same(ref[i], port[i])
    assert port[i]["ok"], port[i]["checks"]
    assert port[i]["committed_lost"] == 0


def test_half_grid_export_is_byte_identical(half):
    (_, jt, jm), (_, t, m) = half
    assert t == jt and m == jm
