"""The plain reference against the port's plain CPU path (the kernels' plain
versions) at tiny sizes: each cell's run comes out correct, every compared
number far inside its limit; and the TF32 emulation rounds as the tensor
cores do."""

import pytest
import torch

from portbench import harness, registry
from portbench.reference import plain

from .small import SEED, shrink

CELLS = [c["name"] for c in registry.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_port_on_cpu(cell, monkeypatch):
    shrink(monkeypatch)
    r = harness.run_cell(cell, SEED, 0.05, False, "cpu")
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] >= 2
    for name, c in r["compared"].items():
        assert c["value"] < min(1e-4, c["limit"] / 3), (name, c)


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0 - 2.0 ** -10])
    got = plain.tf32_round(x)
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -9]
    y = torch.randn(1000)
    assert ((plain.tf32_round(y) - y).abs() <= y.abs() * 2.0 ** -11).all()
