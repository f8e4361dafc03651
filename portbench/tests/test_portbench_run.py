"""The command as the benchmark's check runs it: without a card, or without
the port beside it, it exits non-zero and prints no result; on the card
(`-m gpu`) a short run of each cell prints a correct result line."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import registry

ROOT = registry.ROOT
CELLS = [c["name"] for c in registry.benchmark()["workloads"]]


def run(cwd, cell, seconds=2, trace=0, timeout=600):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                           str(2**32 + 5), "--seconds", str(seconds), "--trace", str(trace)],
                          cwd=cwd, capture_output=True, text=True, timeout=timeout)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the port's CUDA kernels)")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")


def test_refuses_without_a_card(no_card):
    out = run(ROOT, CELLS[0])
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_refuses_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path, CELLS[0])
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell, trace):
    out = run(ROOT, cell, trace=trace)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "compared"
    assert out.stderr.strip().splitlines()[-1].startswith("compared ")
