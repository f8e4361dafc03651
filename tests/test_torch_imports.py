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
from seeme_tpu_torch.eval.t2m_evaluator import T2MEvaluator
from seeme_tpu_torch.models.a2m import A2MConfig, A2MSystem
from seeme_tpu_torch import fit, test_egohmr, test_prohmr_scene, train_egohmr, train_prohmr_scene
from seeme_tpu_torch.tools import (export_fbx, flops, preflight, preprocess_humanml,
                                   preprocess_scene_egohmr, train_evaluator, tsne)
from seeme_tpu_torch.models.egohmr import EgoHmr, EgoHmrConfig
from seeme_tpu_torch.models.prohmr import ProHMRConfig, ProHMRScene
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
            "seeme_tpu_torch.eval.t2m_metrics", "seeme_tpu_torch.nn.resnet",
            "seeme_tpu_torch.eval.stats", "seeme_tpu_torch.test.__main__",
            "seeme_tpu_torch.flows.glow", "seeme_tpu_torch.nn.gcn",
            "seeme_tpu_torch.models.prohmr", "seeme_tpu_torch.models.egohmr",
            "seeme_tpu_torch.data.egohmr_images", "seeme_tpu_torch.eval.hmr_metrics",
            "seeme_tpu_torch.test_prohmr_scene", "seeme_tpu_torch.test_egohmr",
            "seeme_tpu_torch.nn.gru", "seeme_tpu_torch.eval.t2m_evaluator",
            "seeme_tpu_torch.models.text_encoder", "seeme_tpu_torch.data.word_vectorizer",
            "seeme_tpu_torch.config.humanml3d", "seeme_tpu_torch.config.presets",
            "seeme_tpu_torch.core.collision", "seeme_tpu_torch.data.augmentation",
            "seeme_tpu_torch.train_prohmr_scene", "seeme_tpu_torch.train_egohmr",
            "seeme_tpu_torch.models.a2m", "seeme_tpu_torch.nn.action",
            "seeme_tpu_torch.core.rotation2xyz", "seeme_tpu_torch.data.a2m",
            "seeme_tpu_torch.config.a2m", "seeme_tpu_torch.eval.action_classifier",
            "seeme_tpu_torch.eval.stgcn", "seeme_tpu_torch.eval.action_metrics",
            "seeme_tpu_torch.core.motion_process", "seeme_tpu_torch.core.rifke",
            "seeme_tpu_torch.eval.ape_ave", "seeme_tpu_torch.data.prefetch",
            "seeme_tpu_torch.utils.logger", "seeme_tpu_torch.utils.profiling",
            "seeme_tpu_torch.tools.preprocess_humanml", "seeme_tpu_torch.tools.train_evaluator",
            "seeme_tpu_torch.tools.preprocess_scene_egohmr", "seeme_tpu_torch.render.joints",
            "seeme_tpu_torch.render.mesh", "seeme_tpu_torch.render.pyrender_backend",
            "seeme_tpu_torch.render.blender_backend", "seeme_tpu_torch.render.__main__",
            "seeme_tpu_torch.tools.export_gltf", "seeme_tpu_torch.tools.plys2npy",
            "seeme_tpu_torch.tools.export_obj", "seeme_tpu_torch.tools.export_bvh",
            "seeme_tpu_torch.tools.export_fbx", "seeme_tpu_torch.tools.segment_egobody",
            "seeme_tpu_torch.tools.preprocess_egobody", "seeme_tpu_torch.tools.tsne",
            "seeme_tpu_torch.tools.flops", "seeme_tpu_torch.tools.preflight"} <= set(names)
    for name in names:
        importlib.import_module(name)


def test_no_library_kernel_or_torch_build_route():
    text = "\n".join(p.read_text() for p in sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu"))
                     + sorted(PKG.rglob("*.cuh")))
    for banned in ("cpp_extension", "torch.compile", "scaled_dot_product_attention",
                   "torch/extension.h", "import triton"):
        assert banned not in text, banned
    assert sorted(p.name for p in (PKG / "csrc").glob("*.cu")) == [
        "ddim_md.cu", "ddim_md_t1.cu", "ddim_tok.cu", "ddim_tok_t1.cu", "gcn.cu", "pointnet.cu"]
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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        A2MSystem(A2MConfig(), synthetic_smpl(32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T2MEvaluator(text_hidden=8, move_hidden=8, move_out=8, motion_hidden=8, output_size=8)
    small = synthetic_smpl(32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ProHMRScene(ProHMRConfig(flow_hidden=8, flow_layers=1, flow_depth=1), small)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EgoHmr(EgoHmrConfig(gcn_hid_dim=8, gcn_layers=0), small)
    for cli in (test_prohmr_scene, test_egohmr, train_prohmr_scene, train_egohmr):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--tiny"])
    configs = ROOT / "configs"
    for cfg in ("config_mld_humanml3d.yaml", "config_mld_humanact12.yaml"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_evaluator.main(["--cfg", str(configs / cfg), "--out", "unused.tar"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preprocess_humanml.main(["--joints_dir", ".", "--out_vecs", "unused"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preprocess_scene_egohmr.run_s2(".", "unused", "train")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit.main(["--joints", "unused.npy"])
    for tool, argv in ((tsne, ["--cfg", str(configs / "config_vae_egobody.yaml")]),
                       (flops, []), (preflight, ["--deps", "unused"]),
                       (export_fbx, ["--poses", "unused.npy", "--out", "unused.fbx"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(argv)
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
