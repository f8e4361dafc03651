"""The ProHMR-Scene evaluation path in the port against the JAX package,
on the CPU in f32, at the root CLI's `--tiny` size (flow hidden 128 x 4
layers x depth 1, 256 SMPL vertices, 64 x 64 crops, 256 scene points): the
synthetic image data, `ProHMRScene.forward_step` with shared base noise,
the weights carried both ways, and the CLI's metrics against the JAX root
script's on the same weights. `tests/test_torch_egohmr.py` does the same
for EgoHMR with the helpers here (the two JAX models in one file would take
twice the time of one).

One JAX model is shared by the file; its `init_params` tree (perturbed,
batch statistics moved off (0, 1)) reaches the port through
`seeme_tpu_torch/convert.py` and comes back through
`tools/convert_checkpoint.py`.
"""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.core import synthetic_smpl as j_synthetic_smpl
from seeme_tpu.data import egohmr_images as j_images
from seeme_tpu.models.prohmr import ProHMRConfig as JProHMRConfig
from seeme_tpu.models.prohmr import ProHMRScene as JProHMRScene
from seeme_tpu_torch import test_prohmr_scene as prohmr_cli
from seeme_tpu_torch.convert import prohmr_state_dict
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data import egohmr_images as images
from seeme_tpu_torch.data.synthetic import to_torch
from seeme_tpu_torch.models.prohmr import ProHMRConfig, ProHMRScene
from seeme_tpu_torch.ops import pointnet_fused as pfu
from tools import convert_checkpoint as cc

ROOT = Path(__file__).resolve().parent.parent
PRO = dict(flow_hidden=128, flow_depth=1)  # test_prohmr_scene.py --tiny
VERTS, IMG, POINTS, B = 256, 64, 256, 2


def perturbed(tree, seed, scale=0.02):
    """Every leaf moved by seeded noise (variances only upwards), as numpy."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    rs = np.random.RandomState(seed)
    out = []
    for path, leaf in flat:
        a = np.asarray(leaf, np.float32)
        noise = (rs.randn(*a.shape) * scale).astype(np.float32)
        out.append(a + np.abs(noise) if "var" in str(path[-1]) else a + noise)
    return jax.tree.unflatten(treedef, out)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def jx(batch):
    return jax.tree.map(jnp.asarray, batch)


def make_batch(seed=0):
    """An uncorrelated batch of B examples, numpy."""
    rng = np.random.RandomState(seed)
    examples = [images.synthetic_image_example(rng, POINTS, IMG) for _ in range(B)]
    return images.to_model_batch({k: np.stack([e[k] for e in examples]) for k in examples[0]})


@pytest.fixture(scope="module")
def prohmr():
    jm = JProHMRScene(JProHMRConfig(num_test_samples=3, **PRO), j_synthetic_smpl(n_verts=VERTS))
    tree = perturbed(jax.jit(jm.init_params)(jax.random.PRNGKey(0)), 1)
    port = ProHMRScene(ProHMRConfig(num_test_samples=3, **PRO), synthetic_smpl(VERTS),
                       device="cpu")
    port.load_state_dict(prohmr_state_dict(tree), strict=True)
    return jm, tree, port


def test_image_data_matches_jax():
    """Both splits, correlated (FK through each package's SMPL) and not,
    and the model batch's layout."""
    for smpl_pair in ((synthetic_smpl(VERTS), j_synthetic_smpl(n_verts=VERTS)), (None, None)):
        ours = images.EgoHmrImageDataModule(n_pts=POINTS, img_size=IMG, smpl=smpl_pair[0])
        theirs = j_images.EgoHmrImageDataModule(n_pts=POINTS, img_size=IMG, smpl=smpl_pair[1])
        a = next(ours.batches("test", 16, shuffle=False))
        b = next(theirs.batches("test", 16, shuffle=False))
        assert set(a) == set(b) and set(a["smpl_params"]) == set(b["smpl_params"])
        for k in a:
            for x, y in (zip(a[k].values(), b[k].values()) if k == "smpl_params"
                         else [(a[k], b[k])]):
                assert x.shape == np.shape(y) and x.dtype == np.asarray(y).dtype, k
                np.testing.assert_allclose(x, np.asarray(y), atol=1e-4, rtol=1e-5, err_msg=k)


def test_prohmr_forward_step_matches_jax(prohmr):
    """The mode and two draws with the JAX step's own base noise: every
    output within 1e-4 of its max; the PointNet ran its plain blocks."""
    jm, tree, port = prohmr
    batch = make_batch(3)
    key = jax.random.PRNGKey(5)
    want = jax.jit(jm.forward_step)(jx(tree), jx(batch), key)
    noise = np.array(jax.random.normal(key, (B, 2, 144)))  # what the JAX step draws
    before = pfu.fused_input_block.launches, pfu.fused_split_block.launches
    got = port.forward_step(to_torch(batch, "cpu"), noise=torch.as_tensor(noise))
    assert before == (pfu.fused_input_block.launches, pfu.fused_split_block.launches)
    assert set(got) == set(want)
    for k in got:
        assert got[k].shape == want[k].shape, k
        assert rel(got[k].numpy(), want[k]) < 1e-4, k
    assert got["conditioning_feats"].shape == (B, 2566)
    pose = np.asarray(want["pose_6d"][:, 0])
    lp = port.flow_log_prob(torch.from_numpy(pose.copy()), got["conditioning_feats"])
    assert rel(lp.numpy(), jm.flow_log_prob(jx(tree), jnp.asarray(pose),
                                            want["conditioning_feats"])) < 1e-4


def test_prohmr_weights_round_trip(prohmr):
    """The port's state dict through the converter's ProHMR branch
    (`convert_checkpoint.py:635-651`) gives the JAX tree back."""
    _, tree, port = prohmr
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    layers, depth, *_ = cc.infer_glow_shape(sd, "flow.flow")
    back = {
        "backbone": cc.convert_resnet50(sd, "backbone"),
        "scene_enc": cc.convert_pointnet({k[len("scene_enc."):]: v for k, v in sd.items()
                                          if k.startswith("scene_enc.")}),
        "flow": cc.convert_glow(sd, "flow.flow", num_layers=layers, depth=depth),
        "fc_head": {"params": {"fc1": cc.convert_linear(sd, "flow.fc_head.layers.0"),
                               "fc2": cc.convert_linear(sd, "flow.fc_head.layers.2")}},
    }
    want = {k: v for k, v in tree.items() if k != "discriminator"}
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert np.array_equal(a, b)


def jax_sample(jm, params, batch, x_init, noises):
    """`EgoHmr.sample`'s scan, step by step, with the given noise."""
    n = x_init.shape[0]
    sched = jm.sample_schedule
    vis = jm.visibility_mask(batch)
    cond = jm.conditioning(params, batch, vis)
    cond_un = jm.mask_cond(cond, force_mask=True)
    vis6 = jnp.repeat(vis, 6, axis=-1)
    x = jnp.asarray(x_init)
    for i, t in enumerate(range(sched.num_train_timesteps - 1, -1, -1)):
        model_t = jnp.full((n,), int(jm.timestep_map[t]))
        pred = jnp.where(vis6, jm.denoise(params, cond, x, model_t),
                         jm.denoise(params, cond_un, x, model_t))
        eps = jnp.asarray(noises[i]) if t > 0 else jnp.zeros_like(x)
        x = sched.ddpm_step(pred, t, x, eps)
    return jm.forward(params, batch, x, jnp.zeros((n,), jnp.int32), eval_with_uncond=True)


def root_script(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def printed_metrics(text):
    return {k: float(v) for k, v in re.findall(r"^([A-Za-z0-9\-]+):\s+([0-9.]+) mm$", text, re.M)}


CLI_ARGS = ["--tiny", "--batch_size", "16", "--scene_points", str(POINTS)]  # one batch


def run_both(monkeypatch, capsys, tmp_path, name, port_cli, sd):
    """The JAX root script (on the CPU) and the port's CLI on the same
    weights; their printed metrics."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *CLI_ARGS, "--cpu"])
    root_script(name).main()
    want = printed_metrics(capsys.readouterr().out)
    torch.save(sd, tmp_path / "model.pt")
    got = port_cli.main([*CLI_ARGS, "--device", "cpu", "--checkpoint", str(tmp_path / "model.pt")])
    assert set(printed_metrics(capsys.readouterr().out)) == set(got)
    return got, want


def test_prohmr_cli_matches_jax_root_script(prohmr, monkeypatch, capsys, tmp_path):
    _, tree, _ = prohmr
    monkeypatch.setattr(JProHMRScene, "init_params", lambda self, rng: jx(tree))
    got, want = run_both(monkeypatch, capsys, tmp_path, "test_prohmr_scene", prohmr_cli,
                         prohmr_state_dict(tree))
    assert set(got) == set(want) == {"MPJPE", "PA-MPJPE", "V2V"}
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-3 * want[k], (k, got[k], want[k])
