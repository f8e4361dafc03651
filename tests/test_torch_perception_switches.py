"""The perception stack's and the action models' switches against the JAX
package on the CPU, in f32, at the root CLIs' `--tiny` sizes (as
`tests/test_torch_hmr.py` and `tests/test_torch_egohmr.py`):

  * the glow without batch norm (`use_batch_norm=False`);
  * ProHMR-Scene `forward_step` with the camera switches off (the fixed
    focal length and image centre), with and without the glow's batch
    norm, and `compute_loss` on gendered ground-truth bodies with the
    config's own loss weights and NLL noise ratio;
  * EgoHMR with the focal length and box off and `only_mask_img_cond`
    off: conditioning, `forward`, the training loss with the JAX draws and
    the whole sampling step by step;
  * the HumanAct12 evaluator GRU at TEST.EVALUATOR_HIDDEN 64 /
    EVALUATOR_LAYERS 1 and the test CLI that builds it, `rotation2xyz`
    with betas, UESTC's `frontview`.

Each JAX tree (perturbed) reaches the port through `seeme_tpu_torch/convert.py`.
Tolerances: 1e-4 of each output's max, as the files named above; 1e-5 for
the GRU and `rotation2xyz`.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.core import synthetic_smpl as j_synthetic_smpl
from seeme_tpu.core.rotation2xyz import rot6d_motion_to_joints as j_rot6d_motion_to_joints
from seeme_tpu.data.a2m import UestcDataModule as JUestc
from seeme_tpu.eval.action_classifier import MotionDiscriminator as JGru
from seeme_tpu.flows import glow as jglow
from seeme_tpu.models.egohmr import EgoHmr as JEgoHmr
from seeme_tpu.models.egohmr import EgoHmrConfig as JEgoHmrConfig
from seeme_tpu.models.prohmr import ProHMRConfig as JProHMRConfig
from seeme_tpu.models.prohmr import ProHMRScene as JProHMRScene
from seeme_tpu_torch.config import build, loader
from seeme_tpu_torch.convert import egohmr_state_dict, glow_state_dict, prohmr_state_dict
from seeme_tpu_torch.core.rotation2xyz import rot6d_motion_to_joints
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.a2m import UestcDataModule
from seeme_tpu_torch.data.synthetic import to_torch
from seeme_tpu_torch.eval.action_classifier import MotionDiscriminator
from seeme_tpu_torch.flows.glow import ConditionalGlow, GlowConfig
from seeme_tpu_torch.models.egohmr import EgoHmr, EgoHmrConfig
from seeme_tpu_torch.models.prohmr import ProHMRConfig, ProHMRScene
from seeme_tpu_torch.test import __main__ as test_cli
from tools import convert_checkpoint as cc
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)
from test_torch_a2m_data import same_splits, write_uestc
from test_torch_a2m_eval import numpy_sd, seeded
from test_torch_egohmr import EGO
from test_torch_hmr import B, PRO, VERTS, jax_sample, jx, make_batch, perturbed, rel
from test_torch_prohmr_train import batch_np
from torch_egohmr_train_common import jax_draws, with_body_rep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
RTOL = 1e-4


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------------ glow

def test_glow_without_batch_norm_matches_jax():
    """log_prob and sampling with shared noise; no batch-norm keys, and the
    root converter reads the state dict back into the JAX tree."""
    kw = dict(features=12, hidden_features=32, num_layers=3, num_blocks_per_layer=2,
              context_features=7)
    cfg = jglow.GlowConfig(**kw, use_batch_norm=False)
    params = perturbed(jglow.init_glow(jax.random.PRNGKey(0), cfg), 1)
    flow = ConditionalGlow(GlowConfig(**kw, use_batch_norm=False)).eval()
    sd = glow_state_dict(params, "flow")
    assert not any("batch_norm" in k for k in sd)
    flow.load_state_dict({k[len("flow."):]: v for k, v in sd.items()}, strict=True)
    x, ctx, noise = rand(2, 8, 12) * 2 + 1, rand(3, 8, 7), rand(4, 8, 3, 12)
    lp_j, _ = jglow.glow_log_prob(params, cfg, jnp.asarray(x), jnp.asarray(ctx))
    s_j, slp_j, _ = jglow.glow_sample_and_log_prob(params, cfg, 3, jnp.asarray(ctx),
                                                   noise=jnp.asarray(noise))
    with torch.no_grad():
        lp, _ = flow.log_prob(torch.as_tensor(x), torch.as_tensor(ctx))
        s, slp, _ = flow.sample_and_log_prob(3, torch.as_tensor(ctx), noise=torch.as_tensor(noise))
    assert rel(lp.numpy(), lp_j) < RTOL and rel(s.numpy(), s_j) < RTOL
    assert rel(slp.numpy(), slp_j) < RTOL
    back = cc.convert_glow({k: v.numpy() for k, v in sd.items()}, "flow", num_layers=3, depth=2,
                           use_batch_norm=False)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(a, b)


# ------------------------------------------------------------------ ProHMR-Scene

PROHMR_CASES = {
    # the camera switches off and the glow without batch norm, as chip_smoke.py runs them
    "all-off": dict(with_focal_length=False, with_bbox_info=False, with_cam_center=False,
                    use_batch_norm=False),
    "focal-off": dict(with_focal_length=False, focal_length=4000.0),
}


@pytest.fixture(scope="module", params=list(PROHMR_CASES))
def prohmr(request):
    kw = dict(PROHMR_CASES[request.param])
    bn = kw.pop("use_batch_norm", True)
    jm = JProHMRScene(JProHMRConfig(num_test_samples=3, **PRO, **kw),
                      j_synthetic_smpl(n_verts=VERTS))
    jm.glow_cfg = dataclasses.replace(jm.glow_cfg, use_batch_norm=bn)
    tree = perturbed(jax.jit(jm.init_params)(jax.random.PRNGKey(0)), 1)
    port = ProHMRScene(ProHMRConfig(num_test_samples=3, **PRO, **kw, use_batch_norm=bn),
                       synthetic_smpl(VERTS), device="cpu")
    port.load_state_dict(prohmr_state_dict(tree), strict=True)
    return jm, tree, port, jax.jit(jm.forward_step, static_argnames="train")


def test_prohmr_switches_forward_step_matches_jax(prohmr):
    """The narrower context, the cameras without the batch's focal length,
    the glow with or without batch norm: every output within 1e-4 of its
    max, with the JAX step's own base noise."""
    jm, tree, port, forward = prohmr
    batch = make_batch(3)
    key = jax.random.PRNGKey(5)
    want = forward(jx(tree), jx(batch), key)
    noise = np.array(jax.random.normal(key, (B, 2, 144)))
    with torch.no_grad():
        got = port.forward_step(to_torch(batch, "cpu"), noise=torch.as_tensor(noise))
    assert got["conditioning_feats"].shape == (B, port.cfg.total_context)
    assert port.cfg.total_context == jm.cfg.total_context < 2566
    for k in got:
        assert got[k].shape == want[k].shape, k
        assert rel(got[k].numpy(), want[k]) < RTOL, k
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    layers, depth, *_ = cc.infer_glow_shape(sd, "flow.flow")
    back = cc.convert_glow(sd, "flow.flow", num_layers=layers, depth=depth,
                           use_batch_norm=port.cfg.use_batch_norm)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree["flow"])):
        assert np.array_equal(a, b)


def test_prohmr_gendered_loss_matches_jax(prohmr):
    """`compute_loss` with male and female ground-truth bodies picked by
    `batch["gender"]`, non-default loss weights and NLL noise ratio (the
    config's fields), the JAX loss's NLL noise replayed."""
    jm, tree, port, forward = prohmr
    male, female = synthetic_smpl(VERTS, seed=11), synthetic_smpl(VERTS, seed=12)
    weights = dict(port.cfg.loss_weights, V2V_EXP=0.3, KEYPOINTS_3D_EXP=0.1, NLL=0.01)
    cfg = dataclasses.replace(port.cfg, loss_weights=weights, smpl_param_noise_ratio=0.05)
    gendered = ProHMRScene(cfg, synthetic_smpl(VERTS), device="cpu", smpl_male=male,
                           smpl_female=female)
    gendered.load_state_dict(port.state_dict())
    jgendered = JProHMRScene(dataclasses.replace(jm.cfg, loss_weights=weights,
                                                 smpl_param_noise_ratio=0.05),
                             j_synthetic_smpl(n_verts=VERTS),
                             smpl_male=j_synthetic_smpl(n_verts=VERTS, seed=11),
                             smpl_female=j_synthetic_smpl(n_verts=VERTS, seed=12))
    jgendered.glow_cfg = jm.glow_cfg
    batch = make_batch(4)
    batch["gender"] = np.array([0, 1], np.int32)
    key, lkey = jax.random.PRNGKey(6), jax.random.PRNGKey(7)
    jout = forward(jx(tree), jx(batch), key, train=True)
    _, jterms = jax.jit(jgendered.compute_loss, static_argnames="train")(
        jx(tree), jx(batch), jout, lkey, train=True)
    nll_noise = np.array(jax.random.normal(jax.random.split(lkey)[1], (B, 144)))
    flow_noise = np.array(jax.random.normal(key, (B, 1, 144)))
    with torch.no_grad():
        tb = to_torch(batch, "cpu")
        out = gendered.forward_step(tb, noise=torch.as_tensor(flow_noise), train=True)
        _, terms = gendered.compute_loss(tb, out, torch.as_tensor(nll_noise))
        tb_male = dict(tb, gender=torch.zeros_like(tb["gender"]))
        male_terms = gendered.compute_loss(tb_male, out, torch.as_tensor(nll_noise))[1]
    assert set(terms) == set(jterms)
    for k in terms:
        assert rel(terms[k].numpy(), jterms[k]) < RTOL, k
    assert abs(float(male_terms["loss_v2v_mode"]) - float(terms["loss_v2v_mode"])) > 1e-6


# ------------------------------------------------------------------ EgoHMR

EGO_SWITCHES = dict(with_focal_length=False, with_bbox_info=False, only_mask_img_cond=False,
                    cond_mask_prob=0.5)


@pytest.fixture(scope="module")
def egohmr():
    jm = JEgoHmr(JEgoHmrConfig(**EGO, **EGO_SWITCHES), j_synthetic_smpl(n_verts=VERTS))
    tree = perturbed(jax.jit(jm.init_params)(jax.random.PRNGKey(0)), 2)
    port = EgoHmr(EgoHmrConfig(**EGO, **EGO_SWITCHES), synthetic_smpl(VERTS), device="cpu")
    port.load_state_dict(egohmr_state_dict(tree), strict=True)
    return jm, tree, port


def test_egohmr_switches_forward_matches_jax(egohmr):
    """The camera block of the center alone (2 features), the whole
    condition zeroed in the unconditioned branch, `forward` with and
    without the visibility fusion."""
    jm, tree, port = egohmr
    batch = make_batch(4)
    tb = to_torch(batch, "cpu")
    vis = jm.visibility_mask(jx(batch))
    cond_j = jm.conditioning(jx(tree), jx(batch), vis)
    with torch.no_grad():
        cond = port.conditioning(port.encode(tb), port.visibility_mask(tb))
        assert cond.shape[-1] == port.cfg.context_dim == 2048 + 512 + 128 + 2
        assert rel(cond.numpy(), cond_j) < RTOL
        uncond = port.mask_cond(cond)
        assert not bool(uncond.any())
        np.testing.assert_array_equal(uncond.numpy(),
                                      np.asarray(jm.mask_cond(cond_j, force_mask=True)))
        x_t = rand(6, B, 144)
        t = np.array([7, 63], np.int32)
        for fused in (False, True):
            want = jm.forward(jx(tree), jx(batch), jnp.asarray(x_t), jnp.asarray(t),
                              eval_with_uncond=fused)
            got = port(tb, torch.as_tensor(x_t), torch.as_tensor(t, dtype=torch.long),
                       eval_with_uncond=fused)
            for k in ("pred_x_start", "pred_keypoints_3d", "pred_vertices"):
                assert rel(got[k].numpy(), want[k]) < RTOL, (k, fused)


def test_egohmr_switches_training_loss_matches_jax(egohmr):
    """`training_loss` with the JAX step's draws (a drop rate of 0.5, so
    whole conditions are zeroed), the 2D keypoint term on the fixed camera."""
    jm, tree, port = egohmr
    b = with_body_rep(port, batch_np(port.smpl, seed=1))
    key = jax.random.PRNGKey(8)
    draws = jax_draws(jm, key)
    _, jterms = jax.jit(jm.training_loss)(jx(tree), jx(b), key)
    with torch.no_grad():
        _, terms = port.training_loss(to_torch(b, "cpu"),
                                      {k: torch.as_tensor(v) for k, v in draws.items()})
    assert set(terms) == set(jterms)
    for k in terms:
        assert rel(terms[k].numpy(), jterms[k]) < RTOL, k


def test_egohmr_switches_sample_matches_jax(egohmr):
    """The whole sampling with the whole condition zeroed in the
    unconditioned branch, step by step with the same numpy noise."""
    jm, tree, port = egohmr
    batch = make_batch(5)
    rs = np.random.RandomState(7)
    x_init = rs.randn(B, 144).astype(np.float32)
    noises = [rs.randn(B, 144).astype(np.float32) for _ in range(10)]
    want = jax_sample(jm, jx(tree), jx(batch), x_init, noises)
    got = port.sample(to_torch(batch, "cpu"), x_init=torch.as_tensor(x_init),
                      noise=[torch.as_tensor(n) for n in noises])
    for k in ("pred_x_start", "pred_pose_6d", "pred_keypoints_3d", "pred_vertices"):
        assert rel(got[k].numpy(), want[k]) < RTOL, k


def test_egohmr_without_any_camera_feature():
    """Every `with_*` off: the port's camera block is empty, where the JAX
    `_cam_feats` concatenates nothing and raises (`ROADMAP.md` §3)."""
    cfg = dict(with_focal_length=False, with_bbox_info=False, with_cam_center=False)
    batch = make_batch(6)
    with pytest.raises(ValueError):
        JEgoHmr(JEgoHmrConfig(**EGO, **cfg), j_synthetic_smpl(n_verts=VERTS))._cam_feats(
            jx(batch))
    port = EgoHmr(EgoHmrConfig(**EGO, **cfg), synthetic_smpl(VERTS), device="cpu")
    assert port.cfg.context_dim == 2048 + 512 + 128
    with torch.no_grad():
        out = port(to_torch(batch, "cpu"), torch.as_tensor(rand(7, B, 144)),
                   torch.tensor([3, 50]), eval_with_uncond=True)
    assert bool(torch.isfinite(out["pred_vertices"]).all())


# ------------------------------------------------------------------ action-to-motion

def test_evaluator_gru_size_matches_flax(tmp_path, monkeypatch):
    """TEST.EVALUATOR_HIDDEN=64 / EVALUATOR_LAYERS=1 (`test.py:397-401`): the
    builder reads them, the GRU of that size matches the flax one on ragged
    lengths, and the test CLI's action branch evaluates with it."""
    path = os.path.join(CONFIGS, "config_mld_humanact12.yaml")
    sizes = ["TEST.EVALUATOR_HIDDEN=64", "TEST.EVALUATOR_LAYERS=1"]
    tc = build.preset_from_yaml(loader.load_config(
        path, overrides=loader.parse_dotted_overrides(sizes))).test
    assert (tc.evaluator_hidden, tc.evaluator_layers) == (64, 1)
    assert build.preset_from_yaml(loader.load_config(path)).test.evaluator_hidden == 128

    ours = seeded(MotionDiscriminator(hidden_size=64, num_layers=1), 3)
    motion, lengths = rand(4, 4, 16, 72), np.array([16, 9, 3, 12])
    logits, feats = ours(torch.as_tensor(motion), torch.as_tensor(lengths))
    jl, jf = jax.jit(lambda p, m, n: JGru(hidden_size=64, num_layers=1).apply(p, m, n))(
        cc.convert_a2m_gru(numpy_sd(ours)), motion, lengths)
    for got, want in ((feats, jf), (logits, jl)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * float(np.abs(np.asarray(want)).max()))

    built = []
    real = test_cli.action_evaluator
    monkeypatch.setattr(test_cli, "action_evaluator",
                        lambda *a, **k: built.append(real(*a, **k)) or built[-1])
    result = test_cli.main(["--cfg", path, "--device", "cpu", "--out", str(tmp_path), "DEBUG=true",
                            "model.latent_dim=[1,32]", "model.ff_size=16", "model.num_layers=3",
                            "model.scheduler.num_inference_timesteps=3", *sizes])
    gru = built[0].recurrent
    assert (gru.hidden_size, gru.num_layers) == (64, 1)
    assert all(np.isfinite(v) for v in result["replications"][0].values())


@pytest.mark.parametrize("translation", [False, True])
def test_rotation2xyz_with_betas_matches_jax(translation):
    smpl, jsmpl = synthetic_smpl(128), j_synthetic_smpl(n_verts=128)
    feats, betas = rand(8, 2, 6, 150) * 0.4, rand(9, 2, 10)
    got = rot6d_motion_to_joints(smpl, torch.as_tensor(feats), translation,
                                 betas=torch.as_tensor(betas))
    want = j_rot6d_motion_to_joints(jsmpl, jnp.asarray(feats), translation,
                                    betas=jnp.asarray(betas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(want)).max()))
    zero = rot6d_motion_to_joints(smpl, torch.as_tensor(feats), translation)
    assert float((zero - got).abs().max()) > 1e-4


def test_uestc_frontview_matches_jax(tmp_path):
    """`view="frontview"` keeps the side-1 videos only, as the JAX loader."""
    root = write_uestc(tmp_path / "uestc")
    ours = UestcDataModule(str(root), view="frontview")
    same_splits(ours, JUestc(None, str(root), view="frontview"))
    assert ours.num_train < UestcDataModule(str(root)).num_train
    assert ours.split_arrays("test")["action"].tolist() == [3]
