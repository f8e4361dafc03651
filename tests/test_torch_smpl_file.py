"""The SMPL model file read by the port against the JAX package on the CPU:
`load_smpl` on an MPI-layout `.pkl` (chumpy-typed fields through a stand-in
class, a sparse `J_regressor`, (V, 3, 207) pose blend shapes, more shape
blend shapes than the ten read) and on an `.npz` cache, at V = 6890 (with
the extra joint vertices) and V = 256 (without): every tensor bitwise equal
to the JAX loader's, and `smpl_forward` / `smpl_joints24` of the two bodies
within 1e-5 of max |joints|. Then where the file is read: the config
config's fallback, the `--cfg` systems (ego and action), `fit
--smpl_path` and the a2m test CLI on the file's body.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.core import smpl as jsmpl
from seeme_tpu_torch import fit
from seeme_tpu_torch.config import build, loader
from seeme_tpu_torch.config.presets import build as build_preset
from seeme_tpu_torch.config.presets import from_cli
from seeme_tpu_torch.core import smpl as psmpl
from seeme_tpu_torch.test.__main__ import main as eval_cli
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
RTOL = 1e-5
FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "parents",
          "extra_joint_ids")
TINY_A2M = ["model.latent_dim=[1,32]", "model.ff_size=16", "model.num_layers=3",
            "DATASET.NUM_FRAMES=16"]


def body_file(tmp_path, n_verts, ext):
    """A seeded body with 12 shape blend shapes (two past the ten read) in
    the model file's layout."""
    body = psmpl.synthetic_smpl(n_verts=n_verts, seed=n_verts)
    extra = torch.randn(n_verts, 3, 2, generator=torch.Generator().manual_seed(1)) * 0.01
    wide = dataclasses.replace(body, shapedirs=torch.cat([body.shapedirs, extra], dim=-1))
    path = str(tmp_path / f"SMPL_NEUTRAL_{n_verts}.{ext}")
    psmpl.save_smpl(wide, path)
    return path, body


@pytest.fixture(scope="module")
def small_pkl(tmp_path_factory):
    return body_file(tmp_path_factory.mktemp("smpl"), 256, "pkl")


@pytest.mark.parametrize("n_verts,ext", [(6890, "pkl"), (6890, "npz"), (256, "pkl"),
                                         (256, "npz")])
def test_load_smpl_matches_the_jax_loader_bitwise(tmp_path, n_verts, ext):
    path, body = body_file(tmp_path, n_verts, ext)
    ours, ref = psmpl.load_smpl(path), jsmpl.load_smpl(path)
    for name in FIELDS:
        got, want = getattr(ours, name), getattr(ref, name)
        if want is None:
            assert got is None and n_verts != 6890, name
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    np.testing.assert_array_equal(ours.faces, ref.faces)
    assert ours.shapedirs.shape == (n_verts, 3, psmpl.NUM_BETAS)
    assert int(ours.parents[0]) == -1
    # the written arrays come back: the file layout round-trips
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights"):
        assert torch.equal(getattr(ours, name), getattr(body, name)), name
    if n_verts == 6890:
        np.testing.assert_array_equal(ours.extra_joint_ids.numpy(),
                                      psmpl.EXTRA_JOINT_VERTEX_IDS)

    B = 2
    rng = np.random.RandomState(7)
    betas, pose = rng.randn(B, 10).astype(np.float32), 0.3 * rng.randn(B, 69).astype(np.float32)
    orient, transl = 0.3 * rng.randn(B, 3).astype(np.float32), rng.randn(B, 3).astype(np.float32)
    args = [torch.as_tensor(a) for a in (betas, pose, orient, transl)]
    got = psmpl.smpl_forward(ours, *args)
    want = jax.jit(lambda *a: jsmpl.smpl_forward(ref, *a))(betas, pose, orient, transl)
    for key in ("joints", "vertices"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=RTOL * float(np.abs(w).max()), err_msg=key)
    j24 = np.asarray(jsmpl.smpl_joints24(ref, jnp.asarray(betas), jnp.asarray(pose),
                                         jnp.asarray(orient), jnp.asarray(transl)))
    np.testing.assert_allclose(psmpl.smpl_joints24(ours, *args).numpy(), j24, rtol=0,
                               atol=RTOL * float(np.abs(j24).max()))


def test_the_unpickler_maps_chumpy_and_sparse_only(tmp_path):
    """chumpy classes become the stand-in, scipy's csc matrix its class;
    anything else resolves as pickle resolves it."""
    stub = psmpl._SmplUnpickler.find_class(None, "chumpy.ch", "Ch")
    assert stub is psmpl._ChumpyStub
    import scipy.sparse

    for module in ("scipy.sparse.csc", "scipy.sparse._csc"):
        assert psmpl._SmplUnpickler.find_class(None, module, "csc_matrix") \
            is scipy.sparse.csc_matrix
    path = tmp_path / "plain.pkl"
    path.write_bytes(pickle.dumps({"a": np.arange(3)}, protocol=2))
    with open(path, "rb") as f:
        np.testing.assert_array_equal(psmpl._SmplUnpickler(f, encoding="latin1").load()["a"],
                                      np.arange(3))
    empty = psmpl._ChumpyStub()
    with pytest.raises(ValueError, match="no array payload"):
        np.asarray(empty)


def test_config_reads_the_file_or_falls_back(small_pkl):
    path, body = small_pkl
    cfg = loader.load_config(os.path.join(CONFIGS, "config_mld_egobody.yaml"),
                             overrides={"model": {"smpl_path": path}})
    assert build.smpl_path_of(cfg) == path
    assert torch.equal(build.load_smpl_or_synthetic(cfg).v_template, body.v_template)
    absent = loader.load_config(os.path.join(CONFIGS, "config_mld_egobody.yaml"),
                                overrides={"model": {"smpl_path": path + ".absent"}})
    assert build.smpl_path_of(absent) == ""
    fallback = build.load_smpl_or_synthetic(absent)
    assert torch.equal(fallback.v_template, psmpl.synthetic_smpl(n_verts=6890).v_template)


def test_cfg_systems_carry_the_files_body(small_pkl):
    """`--cfg` with model.smpl_path builds the ego and action systems on the
    file's body (no NotImplementedError); `--preset` names no file."""
    path, body = small_pkl
    ego = from_cli(None, os.path.join(CONFIGS, "config_mld_egobody.yaml"), None,
                   [f"model.smpl_path={path}", "model.latent_dim=[1,32]", "model.ff_size=16",
                    "model.num_layers=3", "model.scene_points=64", "model.scene_feat_dim=32"])
    assert ego.smpl_path == path
    _, system = build_preset(ego, torch.device("cpu"))
    assert torch.equal(system.smpl.lbs_weights, body.lbs_weights)
    a2m = from_cli(None, os.path.join(CONFIGS, "config_mld_humanact12.yaml"), None,
                   [f"model.smpl_path={path}"] + TINY_A2M)
    _, system = build_preset(a2m, torch.device("cpu"))
    assert torch.equal(system.smpl.j_regressor, body.j_regressor)
    assert from_cli("mld_humanact12", None).smpl_path == ""


def test_fit_reads_smpl_path(small_pkl, tmp_path):
    path, body = small_pkl
    joints = np.random.RandomState(0).randn(3, 24, 3).astype(np.float32) * 0.3
    np.save(tmp_path / "j.npy", joints)
    out = fit.main(["--cpu", "--joints", str(tmp_path / "j.npy"), "--steps", "3",
                    "--smpl_path", path, "--out", str(tmp_path / "fit.npz"),
                    "--save_mesh", str(tmp_path / "mesh.npy")])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert np.load(tmp_path / "mesh.npy").shape == (3, 256, 3)
    np.testing.assert_array_equal(np.load(tmp_path / "mesh_faces.npy"), body.faces)


def test_a2m_test_cli_runs_on_the_files_body(small_pkl, tmp_path):
    path, _ = small_pkl
    result = eval_cli(["--cfg", os.path.join(CONFIGS, "config_mld_humanact12.yaml"),
                        "--device", "cpu", "--out", str(tmp_path / "t"),
                        f"model.smpl_path={path}", "model.scheduler.num_inference_timesteps=3"]
                       + TINY_A2M)
    assert all(np.isfinite(v["mean"]) for v in result["stats"].values())
