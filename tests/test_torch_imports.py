"""Hygiene of the port: `seeme_tpu_torch/` and `chip_smoke.py` import no JAX,
flax, yaml or JAX-package module; every port module imports on the CPU; the
entry points refuse to fall back to the CPU quietly; the kernels are built by
hand with nvcc into a plain-C library."""

import ast
import importlib
import pkgutil
from pathlib import Path

import numpy as np
import pytest
import torch

import seeme_tpu_torch
from seeme_tpu_torch._device import resolve_device
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
from seeme_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "seeme_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "yaml", "seeme_tpu"}


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: Path):
    """Top-level names of every absolute import in a file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_hygiene_check_matches_names_exactly(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import seeme_tpu_torch.ops\nfrom seeme_tpu_torch import convert\n"
                 "from . import x\nimport seeme_tpu.models as m\nfrom jax import numpy\n")
    assert set(imported_roots(f)) & FORBIDDEN == {"seeme_tpu", "jax"}


def test_every_module_imports():
    names = [m.name for m in pkgutil.walk_packages(seeme_tpu_torch.__path__, "seeme_tpu_torch.")]
    assert {"seeme_tpu_torch.ops.denoiser_fused", "seeme_tpu_torch.models.t2m",
            "seeme_tpu_torch.core.ric", "seeme_tpu_torch.data.humanml",
            "seeme_tpu_torch.eval.t2m_metrics"} <= set(names)
    for name in names:
        importlib.import_module(name)


def test_no_library_kernel_or_torch_build_route():
    text = "\n".join(p.read_text() for p in sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu"))
                     + sorted(PKG.rglob("*.cuh")))
    for banned in ("cpp_extension", "torch.compile", "scaled_dot_product_attention",
                   "torch/extension.h", "import triton"):
        assert banned not in text, banned
    assert sorted(p.name for p in (PKG / "csrc").glob("*.cu")) == [
        "ddim_md.cu", "ddim_tok.cu", "pointnet.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SeeMeSystem(SeeMeConfig(), synthetic_smpl(32), np.zeros(75), np.ones(75))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T2MSystem(T2MConfig(), np.zeros(263), np.ones(263))
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_paths(monkeypatch):
    lib = _build.library_path()
    assert lib.parent == PKG / "_build" and lib.name.startswith("libseeme_kernels_")
    assert lib == _build.library_path()  # named by a hash of sources and flags
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        assert _build.find_nvcc() == "/usr/local/cuda/bin/nvcc"
    else:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()
