"""The benchmark's CPU tests: the repository root and ``src`` on the path,
and the small sizes every test runs a cell at."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.tests.sizes import SIZES  # noqa: E402


@pytest.fixture
def small():
    return SIZES
