"""EgoHMR training in the port against the JAX package, on the CPU, at the
root CLI's `--tiny` size (GCN 128 x 1 layer, 100 diffusion steps, 256 SMPL
vertices, 64 x 64 crops, 256 scene points): `training_loss` with the JAX
step's own draws (timesteps, noise, the condition drop) and one AdamW step
against optax, in float64 on both sides as in
`tests/test_torch_prohmr_train.py` (losses within 1e-5 relative, gradients
within 1e-4 of each tensor's max |g|, every updated tensor, batch
statistics included, within 1e-5 relative); the condition drop and the
capsule penetration term in float32; the training CLI against the root
`train_egohmr.py`; and the training constants of both perception models
against the JAX package's defaults.

The CLI is in `test_torch_egohmr_train_cli.py`, the helpers in
`torch_egohmr_train_common.py`.
"""

import copy
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seeme_tpu.core.collision import (
    point_segment_distance as j_point_segment_distance,
    scene_collision_loss as j_scene_collision_loss,
)
from seeme_tpu.models.egohmr import EgoHmr as JEgoHmr, EgoHmrConfig as JEgoHmrConfig
from seeme_tpu.models.prohmr import ProHMRConfig as JProHMRConfig
from seeme_tpu_torch import train_egohmr as cli
from seeme_tpu_torch.convert import egohmr_state_dict
from seeme_tpu_torch.core.collision import point_segment_distance, scene_collision_loss
from seeme_tpu_torch.data.synthetic import to_torch
from seeme_tpu_torch.models import egohmr as egohmr_model, prohmr as prohmr_model
from seeme_tpu_torch.models.egohmr import EgoHmrConfig
from test_torch_hmr import jx, rel
from test_torch_prohmr_train import B, GRAD_RTOL, LOSS_RTOL, STEP_RTOL, as_float64, batch_np, f64
from torch_egohmr_train_common import (
    EGO,
    egohmr,
    jax_draws,
    with_body_rep,
)
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("model", ["prohmr", "egohmr"])
def test_loss_constants_match_jax(model):
    """The training constants the port keeps as module constants equal the
    JAX package's defaults: ProHMR-Scene's loss weights and NLL noise ratio
    (`ProHMRConfig`), EgoHMR's geometric loss weights (`compute_loss`'s
    keyword defaults) and its condition-drop probability."""
    if model == "prohmr":
        want = JProHMRConfig()
        assert prohmr_model.LOSS_WEIGHTS == want.loss_weights
        assert prohmr_model.SMPL_PARAM_NOISE_RATIO == want.smpl_param_noise_ratio
    else:
        defaults = {k: v.default for k, v in
                    inspect.signature(JEgoHmr.compute_loss).parameters.items()
                    if k.startswith("w_")}
        names = {"w_v2v": "loss_v2v", "w_kp3d": "loss_keypoints_3d",
                 "w_kp3d_full": "loss_keypoints_3d_full", "w_kp2d_full": "loss_keypoints_2d_full",
                 "w_betas": "loss_betas", "w_body_pose": "loss_body_pose",
                 "w_global_orient": "loss_global_orient", "w_ortho": "loss_pose_6d_ortho"}
        assert {names[k]: v for k, v in defaults.items()} == egohmr_model.LOSS_WEIGHTS
        assert egohmr_model.COND_MASK_PROB == JEgoHmrConfig().cond_mask_prob


def test_condition_drop_matches_jax(egohmr):
    """`mask_cond` at train time: the image block of the dropped samples
    zeroed, the rest untouched, as the JAX Bernoulli draw marks them."""
    jm, _, port = egohmr
    cond = np.random.RandomState(2).randn(64, 24, port.cfg.context_dim).astype(np.float32)
    key = jax.random.PRNGKey(9)
    cfg = JEgoHmrConfig(**EGO, cond_mask_prob=0.3)
    want = JEgoHmr(cfg, jm.smpl).mask_cond(jnp.asarray(cond), rng=key, train=True)
    drop = np.array(jax.random.bernoulli(key, 0.3, (64, 1, 1))).reshape(64)
    assert 0 < drop.sum() < 64
    got = port.mask_cond(torch.as_tensor(cond), torch.as_tensor(drop))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_training_step_matches_optax(egohmr):
    """float64: the loss terms of `training_loss` with the JAX draws, every
    gradient and every tensor after the AdamW step of the JAX CLI
    (`train_egohmr.py:80-87`)."""
    jm, tree, port = egohmr
    b = with_body_rep(port, batch_np(port.smpl, seed=1))
    b64 = jax.tree.map(lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, b)
    port = as_float64(copy.deepcopy(port))
    opt = optax.adamw(1e-4, weight_decay=1e-4)

    def step(params, batch, key):  # one compile for the step and its update
        (_, terms), grads = jax.value_and_grad(jm.training_loss, has_aux=True)(params, batch, key)
        return terms, grads, optax.apply_updates(params, opt.update(grads, opt.init(params),
                                                                     params)[0])

    with jax.enable_x64(True):
        params = f64(tree)
        key = jax.random.PRNGKey(6)
        draws = jax_draws(jm, key)
        jterms, grads, new = jax.jit(step)(params, jx(b64), key)
        want = egohmr_state_dict(new)
        want_grads = egohmr_state_dict(jax.tree.map(np.asarray, grads))
    assert draws["drop"].dtype == bool

    port.requires_grad_(True)
    args = cli.parse_args(["--lr", "1e-4", "--weight_decay", "1e-4"], prog="train_egohmr")
    opt_t = cli.adamw(port.parameters(), args)
    loss, terms = port.training_loss(to_torch(b64, "cpu"),
                                     {k: torch.tensor(v) for k, v in draws.items()})
    loss.backward()
    assert set(terms) == set(jterms)
    for k in terms:
        np.testing.assert_allclose(terms[k].item(), float(jterms[k]), rtol=LOSS_RTOL, err_msg=k)
    for name, p in port.named_parameters():
        g = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(g).max()), err_msg=name)
    opt_t.step()
    got = port.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 100 and set(want) == set(got)
    before = egohmr_state_dict(tree)
    for k in want:
        assert rel(got[k].numpy(), want[k].numpy()) <= STEP_RTOL, k
        assert not np.array_equal(got[k].numpy(), before[k].numpy()), k


def test_collision_matches_jax():
    """`point_segment_distance` and `scene_collision_loss` with its gradient
    (`core/collision.py`), scene points scattered around the joints."""
    rs = np.random.RandomState(3)
    joints = rs.randn(2, 24, 3).astype(np.float32) * 0.3
    pts = (joints[:, rs.randint(0, 24, 200)] + rs.randn(2, 200, 3) * 0.08).astype(np.float32)
    a, b = joints[:, :5], joints[:, 5:10]
    np.testing.assert_allclose(
        point_segment_distance(*map(torch.as_tensor, (pts, a, b))).numpy(),
        np.asarray(jax.jit(j_point_segment_distance)(*map(jnp.asarray, (pts, a, b)))), rtol=1e-5,
        atol=1e-6)
    j = torch.tensor(joints, requires_grad=True)
    loss = scene_collision_loss(torch.as_tensor(pts), j)
    loss.backward()
    want, want_g = jax.jit(jax.value_and_grad(j_scene_collision_loss, argnums=1))(
        jnp.asarray(pts), jnp.asarray(joints))
    assert float(want) > 0
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(j.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-4 * float(np.abs(want_g).max()))


def test_compute_loss_with_penetration_matches_jax(egohmr):
    """`weight_coap_penetration` > 0 (0 as shipped): the geometric terms and
    the penetration term of `compute_loss` on the same outputs (the port's
    `forward`), float32."""
    jm, tree, port = egohmr
    cfg = dict(EGO, weight_coap_penetration=0.5)
    jm2 = JEgoHmr(JEgoHmrConfig(**cfg), jm.smpl)
    port2 = copy.deepcopy(port)
    port2.cfg = EgoHmrConfig(**cfg)
    b = batch_np(port.smpl, seed=2)
    x_t = np.random.RandomState(4).randn(B, 144).astype(np.float32)
    t = np.array([3, 50])
    with torch.no_grad():  # the outputs both losses take (`forward` is held to JAX elsewhere)
        tout = port2(to_torch(b, "cpu"), torch.as_tensor(x_t), torch.as_tensor(t))
    out = jax.tree.map(lambda a: jnp.asarray(a.numpy()), tout)
    scene = tout["pred_keypoints_3d_full"][:, :24].numpy()  # points at the body: contact
    b["scene_pcd"] = np.concatenate([b["scene_pcd"], scene + 0.01], axis=1)
    want, wterms = jax.jit(jm2.compute_loss)(jx(b), out)
    got, terms = port2.compute_loss(to_torch(b, "cpu"), tout)
    assert set(terms) == set(wterms) and float(wterms["loss_coap_penetration"]) > 0
    for k in terms:
        np.testing.assert_allclose(terms[k].item(), float(wterms[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
