"""The port's ego variants against the JAX package, on the CPU in f32: the
rotations and SMPL forwards the rot6d and mesh paths use, the ResNet50
image encoder, the VAE's `mlp_dist` and `all_encoder` forms, and
`SeeMeSystem` for the image-conditioned, GIMO, rot6d, no-translation and
interactee-estimating configs, composed as `tests/test_torch_system.py`
composes the flagship (`encode_conditioning` -> `ddim_sample(z_init=...)` ->
decode -> `eval_fk`), at its tolerances; the two losses with dropout off;
and the weight converters for the image encoder.

The port's weights go to the JAX package through
`tools/convert_checkpoint.py` (`convert_mld_checkpoint`, and
`convert_resnet50` for the image encoder), so the same weights feed both.

Here the rotations, SMPL, ResNet50, losses and data; the composed systems
are in `test_torch_variants_systems.py`, the image cache in
`test_torch_variants_image.py`, the helpers in `torch_variants_common.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.core import rotations as jrot, smpl as jsmpl
from seeme_tpu.nn.resnet import resnet50 as j_resnet50
from seeme_tpu.train.state import STAGE_TRAINABLE as J_STAGE_TRAINABLE
from seeme_tpu_torch.convert import from_jax_params, resnet_state_dict
from seeme_tpu_torch.core import rotations as rot, smpl
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.nn.resnet import resnet50
from seeme_tpu_torch.train.state import set_stage
from tools.convert_checkpoint import convert_resnet50
from torch_variants_common import (
    B,
    BOTH,
    build,
    jax_draws,
    POINTS,
    port_resnet,
    random_rotmats,
    SMALL,
    T,
    VARIANTS,
)
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)


def test_rotmat_to_quat_matches_jax():
    """Every pivot of Shepperd's method: random rotations plus rotations of
    pi about each axis, whose trace is -1."""
    R = np.concatenate([random_rotmats(64, 0),
                        np.asarray(jrot.aa_to_rotmat(jnp.asarray(np.pi * np.eye(3, dtype=np.float32))))])
    np.testing.assert_allclose(rot.rotmat_to_quat(torch.as_tensor(R)).numpy(),
                               np.asarray(jrot.rotmat_to_quat(jnp.asarray(R))), atol=1e-6)


@pytest.mark.parametrize("mode", ["prohmr", "diffusion"])
def test_rot6d_matches_jax(mode):
    x = np.random.RandomState(1).randn(5, 7, 6).astype(np.float32)
    np.testing.assert_allclose(rot.rot6d_to_rotmat(torch.as_tensor(x), mode).numpy(),
                               np.asarray(jrot.rot6d_to_rotmat(jnp.asarray(x), mode)), atol=1e-6)
    R = random_rotmats(20, 2).reshape(4, 5, 3, 3).copy()
    six = rot.rotmat_to_rot6d(torch.as_tensor(R), mode)
    np.testing.assert_array_equal(six.numpy(), np.asarray(jrot.rotmat_to_rot6d(jnp.asarray(R), mode)))
    np.testing.assert_allclose(rot.rot6d_to_rotmat(six, mode).numpy(), R, atol=1e-5)
    with pytest.raises(ValueError, match="rot6d mode"):
        rot.rot6d_to_rotmat(torch.as_tensor(x), "other")


@pytest.mark.parametrize("pose2rot", [True, False], ids=["axis-angle", "rotmat"])
def test_smpl_forward_and_rot6d_fk_match_jax(pose2rot):
    """The full skinning forward (joints with the 21 extra vertex joints,
    vertices) and the joints-only path from rotation matrices."""
    model, jmodel = smpl.synthetic_smpl(256), jsmpl.synthetic_smpl(256)
    rng = np.random.RandomState(3)
    n = 4
    betas = rng.randn(n, 10).astype(np.float32)
    transl = rng.randn(n, 3).astype(np.float32)
    if pose2rot:
        pose = rng.randn(n, 69).astype(np.float32) * 0.3
        orient = rng.randn(n, 3).astype(np.float32)
    else:
        R = random_rotmats(n * 24, 4).reshape(n, 24, 3, 3)
        pose, orient = R[:, 1:], R[:, :1]
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    ours = smpl.smpl_forward(model, t(betas), t(pose), t(orient), t(transl), pose2rot=pose2rot)
    ref = jsmpl.smpl_forward(jmodel, jnp.asarray(betas), jnp.asarray(pose), jnp.asarray(orient),
                             jnp.asarray(transl), pose2rot=pose2rot)
    assert ours["joints"].shape == (n, 45, 3)
    for k in ("joints", "vertices"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), atol=1e-5, err_msg=k)
    j24 = smpl.smpl_joints24(model, t(betas), t(pose), t(orient), t(transl), pose2rot=pose2rot)
    np.testing.assert_allclose(j24.numpy(), np.asarray(jsmpl.smpl_joints24(
        jmodel, jnp.asarray(betas), jnp.asarray(pose), jnp.asarray(orient), jnp.asarray(transl),
        pose2rot=pose2rot)), atol=1e-5)
    np.testing.assert_allclose(j24.numpy(), ours["joints"][:, :24].numpy(), atol=1e-5)


def test_resnet50_matches_jax():
    """(2, 64, 64, 3) NHWC crops through both backbones with the same
    weights (the port's state dict through `convert_resnet50`), eval-mode
    batch norm: within 1e-4 of max |out|."""
    net = port_resnet()
    tree = convert_resnet50({k: v.numpy() for k, v in net.state_dict().items()})
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, a: j_resnet50().apply(v, a, train=False))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    with torch.no_grad():
        ours = net(torch.as_tensor(x)).numpy()
    assert ours.shape == (2, 2048)
    np.testing.assert_allclose(ours, ref, atol=1e-4 * float(np.abs(ref).max()))


def test_resnet_weights_round_trip():
    """`convert_resnet50` reads the port's state dict name for name into the
    flax tree `seeme_tpu/nn/resnet.py` declares, `resnet_state_dict`
    inverts it exactly, and a torchvision checkpoint's
    `num_batches_tracked` entries load."""
    net = port_resnet(1)
    sd = net.state_dict()
    tree = convert_resnet50({k: v.numpy() for k, v in sd.items()})
    shapes = jax.eval_shape(lambda: j_resnet50().init(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, 32, 32, 3)), train=False))
    assert jax.tree.structure(tree) == jax.tree.structure(jax.tree.map(lambda _: 0, dict(shapes)))
    assert jax.tree.all(jax.tree.map(lambda a, s: a.shape == s.shape, tree, dict(shapes)))
    back = {k[len("x."):]: v for k, v in resnet_state_dict(tree, prefix="x").items()}
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    other = resnet50()
    other.load_state_dict({**back, "bn1.num_batches_tracked": torch.tensor(7)})
    assert torch.equal(other.bn1.running_var, sd["bn1.running_var"])


@pytest.mark.parametrize("stage,name", [("vae", "gimo"), ("diffusion", "gimo"),
                                        ("diffusion", "image"), ("vae", "estimate-interactee"),
                                        ("vae", "no-transl")])
def test_losses_match_jax(stage, name):
    """Every loss term within 1e-5 relative and every trainable gradient
    within 1e-4 of its max |g|, dropout off. The image config's stage 2
    reads cached `image_feats` (the trainer's route), which `output_images`
    trains through; the raw crops give the same loss."""
    kw = dict(VARIANTS[name], condition=() if stage == "vae" else VARIANTS[name]["condition"])
    data, system, jsystem, params = build(kw)
    nb = data.batch(0, B)
    if system.use_image:
        nb["image_feats"] = np.asarray(jax.jit(jsystem.image_features)(
            params, jnp.asarray(nb.pop("image"))))
    tb, jb = to_torch(nb, "cpu"), {k: jnp.asarray(v) for k, v in nb.items()}
    rng = jax.random.PRNGKey(11)
    trainable_keys = J_STAGE_TRAINABLE[stage]
    loss_fn = jsystem.vae_loss if stage == "vae" else jsystem.diffusion_loss

    def compute(p, b, r):
        p = {k: (v if k in trainable_keys else jax.lax.stop_gradient(v)) for k, v in p.items()}
        return loss_fn(p, b, r)

    (_, jterms), jgrads = jax.jit(jax.value_and_grad(compute, has_aux=True))(params, jb, rng)
    trainable = set_stage(system, stage)
    fn = system.vae_loss if stage == "vae" else system.diffusion_loss
    draws = jax_draws(stage, rng)
    loss, terms = fn(tb, draws=draws)
    loss.backward()
    assert set(terms) == set(jterms)
    for k, v in terms.items():
        np.testing.assert_allclose(v.item(), float(jterms[k]), rtol=1e-5, err_msg=k)
    jgrads = {k: v for k, v in jgrads.items() if k != "image_encoder"}
    ref = from_jax_params(jax.tree.map(np.asarray, jgrads))
    ids = {id(p) for p in trainable}
    for pname, p in system.named_parameters():
        if id(p) not in ids:
            assert p.grad is None, pname
            continue
        g = ref[pname].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=max(1e-4 * float(np.abs(g).max()), 1e-8), err_msg=pname)
    if system.use_image:
        assert float(system.output_images[1].weight.grad.abs().max()) > 0
        set_stage(system, None)
        raw = to_torch(data.batch(0, B), "cpu")
        torch.testing.assert_close(system.diffusion_loss(raw, draws=draws)[0], loss.detach(),
                                   rtol=1e-6, atol=0)


def test_unknown_settings_are_refused():
    data = SyntheticEgoDataset(B, T, scene_points=POINTS, seed=0)
    for kw, match in ((dict(condition=("text",)), "unknown conditions"),
                      (dict(dataset_name="kit"), "dataset_name"),
                      (dict(estimate="both"), "estimate"), (dict(data_type="quat"), "data_type")):
        with pytest.raises(ValueError, match=match):
            SeeMeSystem(SeeMeConfig(**SMALL, **kw), smpl.synthetic_smpl(32), data.mean, data.std,
                        device="cpu")


def test_image_dataset_matches_jax():
    """The synthetic image crops (and every other array) from the same seed
    as the JAX package's; batches carry `image` until `image_feats` is
    attached."""
    from seeme_tpu.data.synthetic import SyntheticEgoDataset as JDataset

    kw = dict(scene_points=16, with_image=True, image_size=24, seed=4)
    ours, theirs = SyntheticEgoDataset(5, 20, **kw), JDataset(5, 20, **kw)
    for k in ("feats", "transl", "betas", "scene", "image", "mean", "std"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(theirs, k), err_msg=k)
    ob, tb = next(ours.batches(2, seed=1)), next(theirs.batches(2, seed=1))
    assert ob.keys() == tb.keys() and "image" in ob
    np.testing.assert_array_equal(ob["image"], tb["image"])
    ours.extras["image_feats"] = np.zeros((5, 7), np.float32)
    assert "image" not in next(ours.batches(2)) and "image" in ours.split_arrays()


def test_gimo_datamodule_matches_jax(tmp_path):
    """GIMO's synthetic module (66 pose features, val read from the test
    split) and its release folder, as the JAX registry builds them."""
    from seeme_tpu.config.loader import Config
    from seeme_tpu.data.registry import get_datamodule as j_get_datamodule
    from seeme_tpu_torch.data.egobody import EgoBodyDataModule
    from seeme_tpu_torch.data.registry import SyntheticDataModule, get_datamodule

    ours = get_datamodule("gimo", BOTH, T, scene_points=16, root=str(tmp_path))
    theirs = j_get_datamodule(Config({"DATASET_NAME": "gimo", "MOTION_LENGTH": T, "model": Config(
        {"condition": list(BOTH), "scene_points": 16}), "DATASET": Config({"ROOT": str(tmp_path)})}))
    assert isinstance(ours, SyntheticDataModule) and ours.nfeats == theirs.nfeats == 69
    np.testing.assert_array_equal(ours.std, theirs.std)
    for split in ("train", "val"):
        for a, b in zip(ours.batches(split, 16, seed=2), theirs.batches(split, 16, seed=2)):
            assert a.keys() == b.keys() and a["feats"].shape[-1] == 66
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(ours.split_array("val", "scene"), ours.split_array("test", "scene"))
    proc = tmp_path / "GIMO" / "processed"
    proc.mkdir(parents=True)
    np.save(proc / "mean.npy", np.zeros(69, np.float32))
    np.save(proc / "std.npy", np.ones(69, np.float32))
    release = get_datamodule("gimo", root=str(tmp_path))
    assert isinstance(release, EgoBodyDataModule) and release.nfeats == 69
