"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the checkout (CPU; the tests marked ``cuda`` run on a card,
``-m cuda``)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def small_cell():
    """``small_cell(name, **sizes)``: the cell of BENCHMARK.json with its
    sizes cut to what a CPU test holds (traffic keys first, then
    configuration keys)."""
    from portbench import spec

    def make(name, **sizes):
        cell = spec.cell(name)
        for k, v in sizes.items():
            (cell.traffic if k in cell.traffic else cell.config)[k] = v
        return cell

    return make
