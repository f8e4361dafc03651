"""The EgoHMR evaluation path in the port against the JAX package, on the
CPU in f32, at the root CLI's `--tiny` size (GCN 128 x 1 layer, ddim10 over
100 steps, 256 SMPL vertices, 64 x 64 crops, 256 scene points):
`EgoHmr.denoise` / `forward`, the whole `sample` composed step by step on
the JAX side with the same numpy noise (the JAX `sample` draws inside its
scan), the weights carried both ways, and the CLI's metrics against the JAX
root script's on the same weights and noise. One JAX model is shared by the
file, as in `tests/test_torch_hmr.py`, whose helpers this file uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.core import synthetic_smpl as j_synthetic_smpl
from seeme_tpu.models.egohmr import EgoHmr as JEgoHmr
from seeme_tpu.models.egohmr import EgoHmrConfig as JEgoHmrConfig
from seeme_tpu_torch import test_egohmr as egohmr_cli
from seeme_tpu_torch.convert import egohmr_state_dict
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.synthetic import to_torch
from seeme_tpu_torch.models.egohmr import EgoHmr, EgoHmrConfig
from test_torch_hmr import B, VERTS, jax_sample, jx, make_batch, perturbed, rel, run_both
from tools import convert_checkpoint as cc
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

EGO = dict(gcn_hid_dim=128, gcn_layers=1, num_train_timesteps=100,
           timestep_respacing="ddim10")  # test_egohmr.py --tiny


@pytest.fixture(scope="module")
def egohmr():
    jm = JEgoHmr(JEgoHmrConfig(**EGO), j_synthetic_smpl(n_verts=VERTS))
    tree = perturbed(jax.jit(jm.init_params)(jax.random.PRNGKey(0)), 2)
    port = EgoHmr(EgoHmrConfig(**EGO), synthetic_smpl(VERTS), device="cpu")
    port.load_state_dict(egohmr_state_dict(tree), strict=True)
    return jm, tree, port


def test_egohmr_denoise_and_forward_match_jax(egohmr):
    jm, tree, port = egohmr
    batch = make_batch(4)
    tb = to_torch(batch, "cpu")
    x_t = np.random.RandomState(6).randn(B, 144).astype(np.float32)
    t = np.array([7, 63], np.int32)
    vis = jm.visibility_mask(jx(batch))
    cond_j = jm.conditioning(jx(tree), jx(batch), vis)
    cond = port.conditioning(port.encode(tb), port.visibility_mask(tb))
    assert rel(cond.numpy(), cond_j) < 1e-4
    assert rel(port.mask_cond(cond).numpy(), jm.mask_cond(cond_j, force_mask=True)) < 1e-4
    want = jm.denoise(jx(tree), cond_j, jnp.asarray(x_t), jnp.asarray(t))
    with torch.no_grad():
        got = port.denoise(cond, torch.as_tensor(x_t), torch.as_tensor(t, dtype=torch.long))
    assert rel(got.numpy(), want) < 1e-4
    for uncond in (False, True):
        want = jm.forward(jx(tree), jx(batch), jnp.asarray(x_t), jnp.asarray(t),
                          eval_with_uncond=uncond)
        got = port(tb, torch.as_tensor(x_t), torch.as_tensor(t, dtype=torch.long),
                   eval_with_uncond=uncond)
        assert np.array_equal(got["vis_mask_smpl"].numpy(), np.asarray(want["vis_mask_smpl"]))
        for k in ("pred_x_start", "pred_pose_6d", "pred_keypoints_3d", "pred_vertices",
                  "pred_keypoints_3d_full"):
            assert rel(got[k].numpy(), want[k]) < 1e-4, (k, uncond)
        for k in ("global_orient", "body_pose", "betas"):
            assert rel(got["pred_smpl_params"][k].numpy(), want["pred_smpl_params"][k]) < 1e-4


def test_egohmr_sample_matches_jax_step_by_step(egohmr):
    """The whole respaced sampling (10 steps, both predictions fused by
    visibility at each) with the same numpy noise: x and every output
    within 1e-4 of its max, the visibility mask equal."""
    jm, tree, port = egohmr
    batch = make_batch(5)
    rs = np.random.RandomState(7)
    x_init = rs.randn(B, 144).astype(np.float32)
    noises = [rs.randn(B, 144).astype(np.float32) for _ in range(10)]
    want = jax_sample(jm, jx(tree), jx(batch), x_init, noises)
    got = port.sample(to_torch(batch, "cpu"), x_init=torch.as_tensor(x_init),
                      noise=[torch.as_tensor(n) for n in noises])
    assert np.array_equal(got["vis_mask_smpl"].numpy(), np.asarray(want["vis_mask_smpl"]))
    assert not got["vis_mask_smpl"].all()  # both branches of the fusion are used
    for k in ("pred_x_start", "pred_pose_6d", "pred_keypoints_3d", "pred_vertices"):
        assert rel(got[k].numpy(), want[k]) < 1e-4, k


def test_egohmr_weights_round_trip(egohmr):
    _, tree, port = egohmr
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = cc.convert_egohmr(sd, num_gcn_layers=cc.infer_gcn_layers(sd))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)


def test_egohmr_cli_matches_jax_root_script(egohmr, monkeypatch, capsys, tmp_path):
    """The root script's sampler replays the port CLI's draws: one
    generator seeded with 1, the batch's initial sample, then one draw a
    step for every step but the last. The test split is one batch of 16,
    so the root script's jitted step is traced, and its noise drawn, once."""
    _, tree, _ = egohmr
    gen = torch.Generator().manual_seed(egohmr_cli.NOISE_SEED)
    calls = []

    def sample(self, params, batch, rng, eval_with_uncond=True):
        calls.append(rng)
        n = batch["img"].shape[0]
        x_init = torch.randn(n, 144, generator=gen).numpy()
        noises = [torch.randn(n, 144, generator=gen).numpy()
                  for _ in range(self.sample_schedule.num_train_timesteps - 1)]
        return jax_sample(self, params, batch, x_init, noises)

    monkeypatch.setattr(JEgoHmr, "init_params", lambda self, rng: jx(tree))
    monkeypatch.setattr(JEgoHmr, "sample", sample)
    got, want = run_both(monkeypatch, capsys, tmp_path, "test_egohmr", egohmr_cli,
                         egohmr_state_dict(tree))
    assert len(calls) == 1
    assert set(got) == set(want) == {"MPJPE", "PA-MPJPE", "V2V", "MPJPE-vis", "MPJPE-invis"}
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-3 * want[k], (k, got[k], want[k])
