"""The control (the reference with TF32 products in the program's place)
comes out not correct: at least one compared number over its limit. On the
card it was read at each cell's own size on four seeds (PERF.md); here at a
size the CPU holds."""

import pytest

from portbench import harness, registry

from .small import SEED, shrink

CELLS = [c["name"] for c in registry.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, monkeypatch):
    shrink(monkeypatch)
    gaps = harness.control_cell(cell, SEED, "cpu")
    limits = registry.reference(registry.workload(registry.benchmark(), cell)["config"]).LIMITS
    assert any(gaps[n] > limits[n] for n in gaps), (gaps, limits)
