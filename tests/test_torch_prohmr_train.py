"""ProHMR-Scene training in the port against the JAX package, on the CPU, at
the root CLI's `--tiny` size (flow hidden 128 x 4 layers x depth 1, 256 SMPL
vertices, 64 x 64 crops, 256 scene points): the `Discriminator`, the ActNorm
start, `compute_loss` with the JAX step's own draws, one generator and one
discriminator AdamW step against optax, and the training CLI against the
root `train_prohmr_scene.py`.

The step is compared in float64 on both sides (the JAX one under
`jax.enable_x64`): Adam's first update is lr * g / (|g| + 1e-8), which turns
float32 rounding in a gradient element near 0 into a visible change of its
parameter, so only float64 lets every updated tensor, batch statistics
included, be held within 1e-5 relative. Losses are held within 1e-5
relative and gradients within 1e-4 of each tensor's max |g| there too.
"""

import copy
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seeme_tpu.core import synthetic_smpl as j_synthetic_smpl
from seeme_tpu.core.rotations import aa_to_rotmat as j_aa_to_rotmat
from seeme_tpu.core.rotations import rotmat_to_rot6d as j_rotmat_to_rot6d
from seeme_tpu.models.prohmr import ProHMRConfig as JProHMRConfig
from seeme_tpu.models.prohmr import ProHMRScene as JProHMRScene
from seeme_tpu_torch import test_prohmr_scene
from seeme_tpu_torch import train_prohmr_scene as cli
from seeme_tpu_torch.convert import prohmr_state_dict
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.augmentation import MoCapDataset
from seeme_tpu_torch.data.egohmr_images import EgoHmrImageDataModule
from seeme_tpu_torch.data.synthetic import to_torch
from seeme_tpu_torch.models.prohmr import GENERATOR, ProHMRConfig, ProHMRScene, gt_pose_6d
from test_torch_hmr import IMG, POINTS, VERTS, jx, perturbed, rel, root_script
from tools import convert_checkpoint as cc
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

PRO = dict(flow_hidden=128, flow_depth=1)  # train_prohmr_scene.py --tiny
B, LOSS_RTOL, GRAD_RTOL, STEP_RTOL = 2, 1e-5, 1e-4, 1e-5
G_KEYS = ("backbone", "scene_enc", "flow", "fc_head")  # `train_prohmr_scene.py:91`


def batch_np(smpl, seed=0):
    """One augmented batch of the CLI's correlated synthetic train split."""
    dm = EgoHmrImageDataModule(n_pts=POINTS, img_size=IMG, smpl=smpl)
    return next(dm.batches("train", B, seed=seed, augment=True))


def as_float64(model):
    """A perception model, its SMPL body included, in float64."""
    model = model.double()
    model.smpl = dataclasses.replace(model.smpl, **{
        f.name: getattr(model.smpl, f.name).double() for f in dataclasses.fields(model.smpl)
        if torch.is_tensor(getattr(model.smpl, f.name))
        and getattr(model.smpl, f.name).is_floating_point()})
    return model


def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def prohmr():
    """The port's seeded weights as the JAX tree, through
    `tools/convert_checkpoint.py` as `tests/test_torch_hmr.py` round-trips
    them (the discriminator, which the converter leaves out, from its JAX
    init), each leaf perturbed, then loaded back into the port. `init_params`
    would compile a full-size ResNet50 forward first."""
    jm = JProHMRScene(JProHMRConfig(**PRO), j_synthetic_smpl(n_verts=VERTS))
    port = ProHMRScene(ProHMRConfig(**PRO), synthetic_smpl(VERTS), device="cpu")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    layers, depth, *_ = cc.infer_glow_shape(sd, "flow.flow")
    tree = perturbed({
        "backbone": cc.convert_resnet50(sd, "backbone"),
        "scene_enc": cc.convert_pointnet({k[len("scene_enc."):]: v for k, v in sd.items()
                                          if k.startswith("scene_enc.")}),
        "flow": cc.convert_glow(sd, "flow.flow", num_layers=layers, depth=depth),
        "fc_head": {"params": {"fc1": cc.convert_linear(sd, "flow.fc_head.layers.0"),
                               "fc2": cc.convert_linear(sd, "flow.fc_head.layers.2")}},
        "discriminator": jax.jit(jm.discriminator.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 23, 3, 3)), jnp.zeros((1, 10))),
    }, 3)
    port.load_state_dict(prohmr_state_dict(tree), strict=True)
    return jm, tree, port


def test_discriminator_matches_jax(prohmr):
    jm, tree, port = prohmr
    rs = np.random.RandomState(1)
    pose = np.array(j_aa_to_rotmat(jnp.asarray(rs.randn(5, 23, 3).astype(np.float32))))
    betas = rs.randn(5, 10).astype(np.float32)
    want = jax.jit(jm.discriminator_outputs)(jx(tree), jnp.asarray(pose), jnp.asarray(betas))
    got = port.discriminator_outputs(torch.as_tensor(pose), torch.as_tensor(betas))
    assert got.shape == (5, 25) and rel(got.numpy(), want) < 1e-5


def test_initialize_actnorm_matches_jax(prohmr):
    """float64 on both sides: each layer's statistics are 1 / std over the
    rows that passed the layers before it, which at B = 2 float32 rounding
    moves by more than 1e-4 relative on some weights; in float64 every
    tensor is held within 1e-6 relative (`prohmr_state_dict` returns the
    JAX side's in float32)."""
    jm, tree, port = prohmr
    b = batch_np(port.smpl)
    port = as_float64(copy.deepcopy(port))
    b64 = jax.tree.map(lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, b)
    tb = to_torch(b64, "cpu")
    with torch.no_grad():  # the context both take (`forward_step` is held to JAX elsewhere)
        ctx_t = port.conditioning_features(tb)
    with jax.enable_x64(True):
        sp = jx(b64["smpl_params"])
        gt6d = jnp.concatenate([
            j_rotmat_to_rot6d(j_aa_to_rotmat(sp["global_orient"]).reshape(B, 1, 3, 3), "prohmr"),
            j_rotmat_to_rot6d(j_aa_to_rotmat(sp["body_pose"].reshape(B, 23, 3)), "prohmr")],
            axis=1).reshape(B, -1)
        want = prohmr_state_dict(jax.jit(jm.initialize_actnorm)(
            f64(tree), gt6d, jnp.asarray(ctx_t.numpy())))
    assert rel(gt_pose_6d(tb["smpl_params"]).numpy(), gt6d) < 1e-12
    port.initialize_actnorm(gt_pose_6d(tb["smpl_params"]), ctx_t)
    got = port.state_dict()
    moved = [k for k in want if k.endswith(("log_scale", "shift"))]
    assert len(moved) == 8
    for k in want:
        assert rel(got[k].numpy(), want[k].numpy()) < 1e-6, k
    assert all(not np.allclose(got[k].numpy(), 0) for k in moved)


def jax_draws(jm, key, n=B):
    """The draws of one JAX G step at batch n from its key
    (`train_prohmr_scene.py:100-103`, `prohmr.py:428-432`): the flow's base
    noise and the NLL's."""
    r1, r2 = jax.random.split(key)
    _, nr = jax.random.split(r2)
    ns = jm.cfg.num_train_samples
    return {"flow": np.array(jax.random.normal(r1, (n, ns - 1, 144))),
            "nll": np.array(jax.random.normal(nr, (n, 144)))}


def jax_g_loss(jm):
    """The root CLI's generator loss (`train_prohmr_scene.py:97-115`)."""
    adv_w = jm.cfg.loss_weights["ADVERSARIAL"]

    def loss_fn(gp, d_params, batch, key):
        full = dict(gp, discriminator=d_params)
        r1, r2 = jax.random.split(key)
        out = jm.forward_step(full, batch, r1, train=True)
        loss, terms = jm.compute_loss(full, batch, out, r2, train=True)
        n = out["body_pose"].shape[0] * out["body_pose"].shape[1]
        disc = jm.discriminator_outputs(full, out["body_pose"].reshape(n, 23, 3, 3),
                                        out["betas"].reshape(n, 10))
        terms["loss_gen"] = jnp.sum((disc - 1.0) ** 2) / B
        fake = (out["body_pose"].reshape(n, 23, 3, 3), out["betas"].reshape(n, 10))
        return loss + adv_w * terms["loss_gen"], (terms, jax.lax.stop_gradient(fake))

    return loss_fn


def jax_d_loss(jm):
    """The root CLI's discriminator loss (`train_prohmr_scene.py:131-145`)."""
    adv_w = jm.cfg.loss_weights["ADVERSARIAL"]

    def loss_fn(dp, mocap, fake):
        full = {"discriminator": dp}
        d_fake = jm.discriminator_outputs(full, *fake)
        d_real = jm.discriminator_outputs(full, j_aa_to_rotmat(mocap["body_pose"].reshape(-1, 23, 3)),
                                          mocap["betas"])
        return adv_w * (jnp.sum(d_fake ** 2) / d_fake.shape[0]
                        + jnp.sum((d_real - 1.0) ** 2) / d_real.shape[0])

    return loss_fn


def test_generator_and_discriminator_steps_match_optax(prohmr):
    """float64: the G loss terms, every G gradient (statistics included),
    the tensors after the G AdamW step, then the D loss and the
    discriminator after its step, against the JAX CLI's steps."""
    jm, tree, port = prohmr
    b = batch_np(port.smpl)
    port = as_float64(copy.deepcopy(port))
    b64 = jax.tree.map(lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, b)
    mocap = next(MoCapDataset(None).batches(B * jm.cfg.num_train_samples,
                                            np.random.RandomState(3)))
    mocap64 = {k: v.astype(np.float64) for k, v in mocap.items()}
    opt = optax.adamw(1e-4, weight_decay=1e-4)

    def step(gp, dp, batch, mocap, key):  # one compile for both steps
        (_, (terms, fake)), grads = jax.value_and_grad(jax_g_loss(jm), has_aux=True)(
            gp, dp, batch, key)
        new_g = optax.apply_updates(gp, opt.update(grads, opt.init(gp), gp)[0])
        d_loss, d_grads = jax.value_and_grad(jax_d_loss(jm))(dp, mocap, fake)
        new_d = optax.apply_updates(dp, opt.update(d_grads, opt.init(dp), dp)[0])
        return terms, grads, new_g, d_loss, d_grads, new_d

    with jax.enable_x64(True):
        t64 = f64(tree)
        gp = {k: t64[k] for k in G_KEYS}
        key = jax.random.PRNGKey(4)
        draws = jax_draws(jm, key)
        jterms, grads, new_g, d_loss, d_grads, new_d = jax.jit(step)(
            gp, t64["discriminator"], jx(b64), jx(mocap64), key)
        want_grads = prohmr_state_dict(dict(jax.tree.map(np.asarray, grads),
                                            discriminator=d_grads))
        want = prohmr_state_dict(dict(new_g, discriminator=new_d))

    args = cli.parse_args(["--lr", "1e-4", "--weight_decay", "1e-4"])
    g_params = []
    for k in GENERATOR:
        getattr(port, k).requires_grad_(True)
        g_params += list(getattr(port, k).parameters())
    port.discriminator.requires_grad_(True)
    opt_g, opt_d = cli.adamw(g_params, args), cli.adamw(port.discriminator.parameters(), args)
    tb = to_torch(b64, "cpu")
    terms, fake_t = cli.g_step(port, opt_g, g_params, tb,
                               {k: torch.tensor(v) for k, v in draws.items()})
    assert set(terms) == set(jterms)
    for k in terms:
        np.testing.assert_allclose(terms[k].item(), float(jterms[k]), rtol=LOSS_RTOL, err_msg=k)
    names = {id(p): n for n, p in port.named_parameters()}
    for p in g_params:
        g = want_grads[names[id(p)]].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(g).max()), err_msg=names[id(p)])
    d_loss_t = cli.d_step(port, opt_d, to_torch(mocap64, "cpu"), fake_t)
    np.testing.assert_allclose(d_loss_t.item(), float(d_loss), rtol=LOSS_RTOL)
    got = port.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 100 and set(want) == set(got)
    before = prohmr_state_dict(tree)
    for k in want:
        assert rel(got[k].numpy(), want[k].numpy()) <= STEP_RTOL, k
        assert not np.array_equal(got[k].numpy(), before[k].numpy()), k


def test_cli_matches_jax_root_script(prohmr, monkeypatch, capsys, tmp_path):
    """Both CLIs from the same weights on the same augmented data, two
    epochs of two steps, the port's draws replayed from the JAX CLI's keys:
    the printed epoch losses agree within 1e-4 relative (plus half the last
    printed digit), and the port's checkpoint loads into its test CLI.

    The learning rate is 1e-8: this random-init model's gradients reach 1e6,
    so Adam's first updates (about lr * sign(g)) flip with the rounding of
    the elements whose gradient cancels to near 0, in either package; at
    1e-4 such flips move the next step's loss by percents. The updates
    themselves are held to optax by the step test above."""
    jm, tree, _ = prohmr
    monkeypatch.setattr(JProHMRScene, "init_params", lambda self, rng: jx(tree))
    argv = ["--tiny", "--batch_size", "32", "--epochs", "2", "--lr", "1e-8",
            "--scene_points", str(POINTS), "--out", str(tmp_path / "jax")]
    monkeypatch.setattr(sys, "argv", ["train_prohmr_scene.py", *argv, "--cpu"])
    root_script("train_prohmr_scene").main()
    want = capsys.readouterr().out

    keys, rng = [], jax.random.PRNGKey(1)
    for _ in range(4):
        rng, step = jax.random.split(rng)
        keys.append(step)
    monkeypatch.setattr(ProHMRScene, "__init__",
                        loading_init(ProHMRScene.__init__, prohmr_state_dict(tree)))
    argv[-1] = str(tmp_path / "port")
    got = cli.main([*argv, "--device", "cpu"], draws=lambda i: jax_draws(jm, keys[i], 32))
    assert "ActNorm initialized on first batch" in capsys.readouterr().out
    lines = [line for line in want.splitlines() if line.startswith("epoch")]
    assert len(lines) == 2
    for line, g, d in zip(lines, got["g_losses"], got["d_losses"]):
        wg = float(line.split("G loss ")[1].split()[0])
        wd = float(line.split("D loss ")[1].split()[0])
        assert abs(g - wg) <= 1e-4 * abs(wg) + 5e-5, (g, wg)
        assert abs(d - wd) <= 1e-4 * abs(wd) + 5e-6, (d, wd)
    monkeypatch.undo()
    metrics = test_prohmr_scene.main(["--tiny", "--device", "cpu", "--scene_points", str(POINTS),
                                      "--checkpoint", got["checkpoint"]])
    assert all(np.isfinite(v) for v in metrics.values())


def loading_init(init, sd):
    """`init`, then `sd` loaded: the CLI's model starts from the JAX tree."""
    def wrapped(self, *a, **kw):
        init(self, *a, **kw)
        self.load_state_dict(sd, strict=True)
    return wrapped
