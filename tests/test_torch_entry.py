"""The port's root entry points (`python -m seeme_tpu_torch.demo`,
`scene_encoder`, `fit`) against the JAX CLIs at the repo root (`demo.py`,
`scene_encoder.py`, `fit.py`), on the CPU at small widths.

The demo writes what the JAX demo writes for the same config, weights and
noise (the JAX systems' `init_params` return the port's seeded weights, and
every latent-shaped draw of `torch.randn` and `jax.random.normal` returns
the same numpy noise): the same file names, shapes and dtypes, and every
array within 1e-4 of its max (sampled, random, reconstructed, action and
ground-truth joints, meshes and faces; the port recovers the text model's
joints in float64, the JAX package in float32); the captions file equal.
The scene encoder's embedding of the root script's seeded cloud equals the
flax module's on the same weights. Three fitting iterations (Adam over SMPL
joints, the pose, angle and betas priors) equal
`fit.py::fit_smpl_to_joints`' in float64 within 1e-6 relative, which holds
`torch.optim.Adam` to `optax.adam`.
"""

import contextlib
import dataclasses
import importlib.util
import os
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.config.loader import load_config as j_load_config
from seeme_tpu.config.loader import parse_dotted_overrides as j_overrides
from seeme_tpu.core.pose_prior import MaxMixturePrior as JPrior
from seeme_tpu.core.smpl import synthetic_smpl as j_synthetic_smpl
from seeme_tpu.data import get_datamodule as j_get_datamodule
from seeme_tpu.models.a2m import A2MSystem as JA2MSystem
from seeme_tpu.models.seeme import SeeMeSystem as JSeeMeSystem
from seeme_tpu.models.t2m import T2MSystem as JT2MSystem
from seeme_tpu.nn.pointnet import ResnetPointnet as JPointnet
from seeme_tpu_torch import demo, fit, scene_encoder
from seeme_tpu_torch.config import build, loader
from seeme_tpu_torch.core.pose_prior import MaxMixturePrior
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.nn.init import init_parameters_
from seeme_tpu_torch.nn.pointnet import ResnetPointnet
from seeme_tpu_torch.ops import denoiser_fused as dfu
from tools import convert_checkpoint as cc

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "configs"
SMALL = ["model.ff_size=16", "model.num_layers=3", "model.scheduler.num_inference_timesteps=3"]
EGO = SMALL + ["model.latent_dim=[2,32]", "model.scene_points=64", "model.scene_feat_dim=32"]
TEXT = SMALL + ["model.latent_dim=[2,32]"]
ACTION = SMALL + ["model.latent_dim=[2,32]"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the models are tiny and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def root_module(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_weights(cfg_path, overrides):
    """The port demo's seeded weights for a config, as the JAX param tree."""
    cfg = loader.load_config(cfg_path, overrides=loader.parse_dotted_overrides(overrides))
    system = build.build_system(cfg, torch.device("cpu"))[2]
    sd = {k: v.detach().numpy().copy() for k, v in system.state_dict().items()}
    tree = cc.convert_mld_checkpoint(sd)
    if "embed_action.action_embedding" in sd:
        tree["embed_action"] = {"params": {"action_embedding": sd["embed_action.action_embedding"]}}
    return jax.tree.map(jnp.asarray, tree)


def run_jax_demo(branch, argv, overrides, out):
    """The root demo's branch for a config, as its `main` runs it (on the
    CPU), on the port demo's weights: the systems' `init_params` return them
    (the JAX init of the full ego system takes tens of seconds to compile)."""
    root = root_module("demo")
    with mock.patch.object(sys, "argv", ["demo.py", *argv, "--out", str(out)]):
        args = root.parse_args()
    cfg = j_load_config(args.cfg, overrides=j_overrides(overrides))
    os.makedirs(out, exist_ok=True)
    params = port_weights(args.cfg, overrides)
    init = lambda self, rng: params  # noqa: E731
    with mock.patch.object(JSeeMeSystem, "init_params", init), \
            mock.patch.object(JT2MSystem, "init_params", init), \
            mock.patch.object(JA2MSystem, "init_params", init):
        return getattr(root, branch)(args, cfg, j_get_datamodule(cfg))


def latent_noise(shape):
    return np.random.RandomState(len(shape) + sum(shape)).randn(*shape).astype(np.float32)


@contextlib.contextmanager
def same_latent_noise(latent_dim):
    """Every draw of shape (n, *latent_dim) from `torch.randn` or
    `jax.random.normal` returns `latent_noise(shape)`: the initial DDIM
    noise, the random-sampling latents and the reconstruction's eps of both
    demos. Yields the shapes served to each side."""
    served = {"torch": [], "jax": []}
    real_randn, real_normal = torch.randn, jax.random.normal

    def hits(shape):
        return len(shape) == 3 and tuple(shape[1:]) == tuple(latent_dim)

    def randn(*size, **kw):
        shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else size
        if not hits(shape):
            return real_randn(*size, **kw)
        served["torch"].append(shape)
        return torch.as_tensor(latent_noise(shape), device=kw.get("device") or "cpu")

    def normal(key, shape=(), dtype=jnp.float32):
        if not hits(tuple(shape)):
            return real_normal(key, shape, dtype)
        served["jax"].append(tuple(shape))
        return jnp.asarray(latent_noise(tuple(shape)), dtype)

    with mock.patch.object(torch, "randn", randn), \
            mock.patch.object(jax.random, "normal", normal):
        yield served


def run_both(branch, argv, overrides, out, latent_dim):
    """The port's demo and the root demo's branch on the same weights and
    latent noise; both return the joint files they wrote."""
    with same_latent_noise(latent_dim) as served:
        saved = demo.main([*argv, "--cpu", "--out", str(out / "ours"), *overrides])
        ref = run_jax_demo(branch, argv, overrides, out / "ref")
    assert served["torch"] and served["jax"], served
    assert [os.path.basename(p) for p in saved] == [os.path.basename(p) for p in ref]
    return saved


def files(folder):
    return sorted(os.listdir(folder))


def check_same_files(ours, ref):
    """The same file names; every array of the same shape and dtype, finite
    and within 1e-4 of the reference's max; every text file equal."""
    assert files(ours) == files(ref)
    for name in files(ref):
        if not name.endswith(".npy"):
            assert (ours / name).read_text() == (ref / name).read_text(), name
            continue
        a, b = np.load(ours / name), np.load(ref / name)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), name
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * float(np.abs(b).max()),
                                   err_msg=name)


def test_demo_ego_with_mesh_writes_what_the_jax_demo_writes(tmp_path):
    """`config_mld_egobody.yaml` at latent [2, 32] with `--mesh`: samples,
    ground truth, meshes and faces; one DDIM call a batch (its plain
    version on the CPU, no launch)."""
    argv = ["--cfg", str(CONFIGS / "config_mld_egobody.yaml"), "--num_samples", "2", "--mesh"]
    before = dfu.ddim_fused.launches
    run_both("_demo_ego", argv, EGO, tmp_path, (2, 32))
    assert dfu.ddim_fused.launches == before
    check_same_files(tmp_path / "ours", tmp_path / "ref")
    assert np.load(tmp_path / "ours" / "sample_0_mesh.npy").shape == (60, 6890, 3)


@pytest.mark.parametrize("task", ["example", "random_sampling", "reconstruction"])
def test_demo_text_writes_what_the_jax_demo_writes(task, tmp_path):
    """`config_mld_humanml3d.yaml` with an `--example` file (latent [2, 32],
    lengths and a plain caption line), `--task random_sampling` and
    `--task reconstruction`."""
    argv = ["--cfg", str(CONFIGS / "config_mld_humanml3d.yaml"), "--num_samples", "3"]
    if task == "example":
        example = tmp_path / "captions.txt"
        example.write_text("40 a person walks forward\n\n24 someone jumps twice\na person waves\n")
        argv += ["--example", str(example), "--length", "32"]
    else:
        argv += ["--task", task]
    overrides = TEXT if task == "example" else SMALL + ["model.latent_dim=[1,32]"]
    run_both("_demo_text", argv, overrides, tmp_path, (2, 32) if task == "example" else (1, 32))
    check_same_files(tmp_path / "ours", tmp_path / "ref")
    if task == "example":
        assert [np.load(tmp_path / "ours" / f"sample_{i}.npy").shape[0] for i in range(3)] == [
            40, 24, 32]


def test_demo_action_writes_what_the_jax_demo_writes(tmp_path):
    """`config_mld_humanact12.yaml` with `--actions 0,5,11 --replication 2`."""
    argv = ["--cfg", str(CONFIGS / "config_mld_humanact12.yaml"), "--actions", "0,5,11",
            "--replication", "2"]
    run_both("_demo_action", argv, ACTION, tmp_path, (2, 32))
    check_same_files(tmp_path / "ours", tmp_path / "ref")


def test_demo_render_is_not_ported(tmp_path, monkeypatch):
    """`--render` is ported (`tests/test_torch_render.py`); on a host
    without matplotlib it refuses with an ImportError naming it, after the
    samples are written."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        demo.main(["--cfg", str(CONFIGS / "config_mld_humanact12.yaml"), "--render", "--cpu",
                   "--actions", "0", "--out", str(tmp_path), *ACTION])
    assert files(tmp_path) == ["action_0.npy"]


def test_scene_encoder_matches_the_flax_module(tmp_path):
    """The seeded random cloud of the root script through the port's fused
    path (plain blocks on the CPU) against the flax `ResnetPointnet(512,
    256)` on the same weights; a ProHMR-style checkpoint loads by prefix."""
    enc = ResnetPointnet(out_dim=512, hidden_dim=256)
    init_parameters_(enc, torch.Generator().manual_seed(7))
    torch.save({f"scene_enc.{k}": v for k, v in enc.state_dict().items()}, tmp_path / "m.pt")
    ours = scene_encoder.main(["--cpu", "--points", "777", "--checkpoint", str(tmp_path / "m.pt")])
    params = cc.convert_pointnet({k: v.numpy() for k, v in enc.state_dict().items()})
    pcd = np.random.RandomState(0).randn(1, 777, 3).astype(np.float32)
    ref = np.asarray(JPointnet(out_dim=512, hidden_dim=256).apply(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pcd)))
    assert ours.shape == (1, 512)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4 * float(np.abs(ref).max()))
    again = scene_encoder.main(["--cpu", "--points", "777"])  # the seeded init
    assert again.shape == (1, 512) and not torch.equal(again, ours)


def f64_smpl():
    """The synthetic body in float64 (the JAX one built under x64)."""
    port = synthetic_smpl(n_verts=512, seed=3)
    return dataclasses.replace(port, **{
        f.name: getattr(port, f.name).double() for f in dataclasses.fields(port)
        if torch.is_tensor(getattr(port, f.name)) and getattr(port, f.name).is_floating_point()})


@pytest.mark.parametrize("prior", ["none", "gmm_fallback"])
def test_three_fit_iterations_match_jax_in_float64(prior):
    """Three Adam steps of the fitting loop from the same joints, float64 on
    both sides: every fitted parameter and the final loss terms within 1e-6
    relative of `fit.py::fit_smpl_to_joints`."""
    root_fit = root_module("fit")
    port_smpl = f64_smpl()
    with jax.enable_x64(True):
        j_smpl = j_synthetic_smpl(n_verts=512, seed=3, dtype=jnp.float64)
        target = np.random.RandomState(4).randn(5, 24, 3) * 0.3
        ref_params, ref_terms = root_fit.fit_smpl_to_joints(
            j_smpl, jnp.asarray(target), num_steps=3, lr=0.02,
            pose_prior=JPrior(None) if prior != "none" else None)
        ref_params = {k: np.asarray(v) for k, v in ref_params.items()}
    params, terms = fit.fit_smpl_to_joints(
        port_smpl, torch.as_tensor(target), num_steps=3, lr=0.02,
        pose_prior=MaxMixturePrior(None) if prior != "none" else None)
    for k, want in ref_params.items():
        got = params[k].numpy()
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(np.abs(want).max(), 1e-12),
                                   err_msg=k)
    for k in ref_terms:
        np.testing.assert_allclose(terms[k], ref_terms[k], rtol=1e-6, err_msg=k)


def test_fit_cli_writes_the_fitted_body(tmp_path):
    """The CLI on a demo-like joint file: the loss falls, the parameters and
    the mesh are written, as `fit.py` writes them."""
    joints = np.random.RandomState(5).randn(6, 24, 3).astype(np.float32) * 0.2
    np.save(tmp_path / "joints.npy", joints)
    out = fit.main(["--cpu", "--joints", str(tmp_path / "joints.npy"), "--steps", "15",
                    "--gmm", str(tmp_path / "absent"), "--out", str(tmp_path / "fit.npz"),
                    "--save_mesh", str(tmp_path / "mesh.npy")])
    assert out["losses"][-1] < out["losses"][0]
    saved = np.load(tmp_path / "fit.npz")
    assert sorted(saved.files) == ["betas", "body_pose", "global_orient", "transl"]
    assert saved["body_pose"].shape == (6, 69) and saved["betas"].shape == (1, 10)
    assert np.load(tmp_path / "mesh.npy").shape == (6, 6890, 3)
    assert (tmp_path / "mesh_faces.npy").exists()
