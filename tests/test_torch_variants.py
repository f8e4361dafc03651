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
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.core import rotations as jrot
from seeme_tpu.core import smpl as jsmpl
from seeme_tpu.diffusion.sampling import ddim_sample
from seeme_tpu.models.seeme import SeeMeConfig as JConfig
from seeme_tpu.models.seeme import SeeMeSystem as JSystem
from seeme_tpu.models.vae import MotionVae as JMotionVae
from seeme_tpu.nn.resnet import resnet50 as j_resnet50
from seeme_tpu.train.state import STAGE_TRAINABLE as J_STAGE_TRAINABLE
from seeme_tpu_torch.convert import from_jax_params, resnet_state_dict
from seeme_tpu_torch.core import rotations as rot
from seeme_tpu_torch.core import smpl
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.models.vae import MotionVae
from seeme_tpu_torch.nn.init import init_parameters_, perturb_parameters_
from seeme_tpu_torch.nn.resnet import resnet50
from seeme_tpu_torch.train.state import set_stage
from tools.convert_checkpoint import convert_mld_checkpoint, convert_motion_vae, convert_resnet50

B, W, STEPS, POINTS, T, IMAGE = 3, 32, 5, 64, 60, 32
SMALL = dict(latent_dim=(1, W), ff_size=16, num_layers=3, num_inference_timesteps=STEPS,
             scene_points=POINTS, scene_feat_dim=W, dropout=0.0)
BOTH = ("interactee", "scene")
IMAGE_COND = ("interactee", "scene", "image")


def random_rotmats(n, seed):
    aa = np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    return np.asarray(jrot.aa_to_rotmat(jnp.asarray(aa)))


def randomize_batch_stats_(module, generator):
    """Running statistics away from (0, 1), so the eval-mode batch norm is
    held to more than an identity."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "running_var"):
                m.running_mean.normal_(0.0, 0.1, generator=generator)
                m.running_var.uniform_(0.5, 1.5, generator=generator)


# ------------------------------------------------------------ rotations, SMPL

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


# ------------------------------------------------------------------ ResNet50

def port_resnet(seed=0):
    net = resnet50()
    g = torch.Generator().manual_seed(seed)
    init_parameters_(net, g)
    perturb_parameters_(net, g)
    randomize_batch_stats_(net, g)
    return net


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


# ---------------------------------------------------------------------- VAE

@pytest.mark.parametrize("arch,mlp_dist", [("encoder_decoder", True), ("all_encoder", False),
                                           ("all_encoder", True)])
def test_vae_variants_match_jax(arch, mlp_dist):
    """`mlp_dist` (latent_size tokens through `dist_layer`) and the
    all-encoder decoder: encode and decode within 1e-5 of the flax VAE on
    the port's weights (`convert_motion_vae`)."""
    vae = MotionVae(75, (1, W), 16, 3, dropout=0.0, arch=arch, mlp_dist=mlp_dist)
    init_parameters_(vae, torch.Generator().manual_seed(0))
    perturb_parameters_(vae, torch.Generator().manual_seed(1))
    assert ("dist_layer.weight" in vae.state_dict()) == mlp_dist
    params = jax.tree.map(jnp.asarray, convert_motion_vae(
        {k: v.numpy() for k, v in vae.state_dict().items()}, 3, arch=arch))
    jvae = JMotionVae(75, (1, W), 16, 3, dropout=0.0, arch=arch, mlp_dist=mlp_dist)
    x = np.random.RandomState(2).randn(B, T, 75).astype(np.float32)
    lengths = np.array([T, 41, 17])
    with torch.no_grad():
        mu, logvar = vae.encode(torch.as_tensor(x), torch.as_tensor(lengths))
        out = vae.decode(mu, T, torch.as_tensor(lengths))
    jmu, jlogvar = jvae.apply(params, jnp.asarray(x), jnp.asarray(lengths), method=jvae.encode)
    jout = jvae.apply(params, jmu, T, jnp.asarray(lengths), method=jvae.decode)
    for a, b in ((mu, jmu), (logvar, jlogvar), (out, jout)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    with pytest.raises(ValueError, match="arch"):
        MotionVae(75, arch="trans_dec")


# ------------------------------------------------------------------- system

VARIANTS = {
    "image": dict(condition=IMAGE_COND),
    "gimo": dict(condition=BOTH, dataset_name="gimo"),
    "rot6d": dict(condition=("interactee",), data_type="rot6d"),
    "no-transl": dict(condition=BOTH, predict_transl=False),
    "estimate-interactee": dict(condition=("interactee",), estimate="interactee"),
}


def build(variant_kw, guidance=1.0):
    cfg = SeeMeConfig(guidance_scale=guidance, image_size=IMAGE, **SMALL, **variant_kw)
    data = SyntheticEgoDataset(B, T, pose_feats=cfg.pose_feats, scene_points=POINTS,
                               with_image="image" in cfg.condition, image_size=IMAGE, seed=0)
    system = SeeMeSystem(cfg, smpl.synthetic_smpl(256), data.mean, data.std, device="cpu", seed=1)
    perturb_parameters_(system, torch.Generator().manual_seed(2))
    if system.use_image:
        randomize_batch_stats_(system.image_encoder, torch.Generator().manual_seed(3))
    jcfg = JConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                      if f.name != "image_size"})
    jsystem = JSystem(jcfg, jsmpl.synthetic_smpl(256), data.mean, data.std)
    return data, system, jsystem, jax_params(system)


def jax_params(system):
    """The JAX tree of the port's weights, in memory of its own."""
    sd = {k: v.detach().numpy().copy() for k, v in system.state_dict().items()}
    tree = convert_mld_checkpoint(sd)
    if system.use_image:
        tree["image_encoder"] = convert_resnet50(sd, prefix="image_encoder")
    return jax.tree.map(lambda a: jnp.array(a, copy=True), tree)


@pytest.mark.parametrize("name,guidance", [("image", 1.0), ("image", 2.5), ("gimo", 1.0),
                                           ("rot6d", 1.0), ("no-transl", 1.0),
                                           ("estimate-interactee", 1.0)])
def test_variant_matches_jax_composition(name, guidance):
    """Condition tokens, sampled features, joints and orientations of each
    variant against the JAX package (the image's uncond half at guidance
    2.5 from a zeroed image)."""
    data, system, jsystem, params = build(VARIANTS[name], guidance)
    nb = data.batch(0, B)
    tb, jb = to_torch(nb, "cpu"), {k: jnp.asarray(v) for k, v in nb.items()}
    z0 = np.random.RandomState(3).randn(B, 1, W).astype(np.float32)

    cond = system.encode_conditioning(tb)
    jcond = jax.jit(jsystem.encode_conditioning)(params, jb)
    n_tok = len(system.cfg.condition)
    assert cond.shape == ((2 if guidance > 1 else 1) * B, n_tok, W)
    np.testing.assert_allclose(cond.numpy(), np.asarray(jcond), atol=1e-4)

    feats = system.sample_from_cond(cond, z_init=torch.as_tensor(z0))
    z = ddim_sample(lambda x, t, r: jsystem.denoiser.apply(params["denoiser"], x, t, jcond),
                    jsystem.schedule, jax.random.PRNGKey(0), z0.shape,
                    num_inference_steps=STEPS, guidance_scale=guidance, z_init=z0)
    jfeats = jax.jit(lambda p, z: jsystem.vae.apply(p, z, T, method=jsystem.vae.decode))(
        params["vae"], z)
    assert feats.shape == (B, T, system.cfg.nfeats)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats),
                               atol=1e-4 * float(np.abs(jfeats).max()))

    out, jout = system.eval_fk(tb, feats), jax.jit(jsystem.eval_fk)(params, jb, jfeats)
    for k in ("joints_rst", "joints_ref", "joints_int", "quat_rst", "quat_ref"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["gimo", "rot6d", "no-transl"])
def test_feats_to_vertices_matches_jax(name):
    data, system, jsystem, params = build(VARIANTS[name])
    nb = data.batch(0, B)
    tb = to_torch(nb, "cpu")
    raw = system.renorm(system.actor_features(tb, 0))
    betas, transl = tb["betas"][:, 0], tb["transl"][:, 0]
    ours = system.feats_to_vertices(raw, betas, transl)
    ref = jsystem.feats_to_vertices(jnp.asarray(raw.numpy()), jnp.asarray(nb["betas"][:, 0]),
                                    jnp.asarray(nb["transl"][:, 0]))
    assert ours.shape == (B, T, 256, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def jax_draws(stage, rng):
    """The draws `vae_loss` / `diffusion_loss` make from `rng` at guidance 1,
    re-derived from the JAX package's key splits (`seeme_tpu/models/seeme.py:343`, `:437`)."""
    shape = (B, 1, W)
    if stage == "vae":
        _, sample_rng = jax.random.split(rng)
        return {"eps": torch.tensor(np.asarray(jax.random.normal(sample_rng, shape)))}
    _, z_rng, t_rng, noise_rng, _ = jax.random.split(rng, 5)
    draws = {"eps": jax.random.normal(z_rng, shape), "noise": jax.random.normal(noise_rng, shape),
             "timesteps": jax.random.randint(t_rng, (B,), 0, 1000)}
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


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


def test_image_cache_keys_leave_the_kernel_copies_alone():
    """Running the image encoder neither rebuilds the DDIM or PointNet
    kernel-layout copies nor is touched by them; a load of new weights
    reaches the image features."""
    data, system, _, _ = build(VARIANTS["image"])
    tb = to_torch(data.batch(0, B), "cpu")
    sd, ddim, scene = system.kernel_operands()
    feats = system.image_features(tb["image"])
    system.scene_features(tb["scene"])
    assert system.kernel_operands()[1] is ddim and system.kernel_operands()[2] is scene
    other = build(VARIANTS["image"])[1]
    perturb_parameters_(other, torch.Generator().manual_seed(9))
    system.load_state_dict(other.state_dict())
    assert not torch.equal(system.image_features(tb["image"]), feats)
    assert torch.equal(system.image_features(tb["image"]), other.image_features(tb["image"]))


def test_image_weights_carry_across():
    """A JAX image-config tree (image encoder params and batch stats,
    `output_images`) -> `from_jax_params` -> a strict `load_state_dict`,
    and back through the converters to the same tree."""
    data, system, jsystem, _ = build(VARIANTS["image"])
    shapes = jax.eval_shape(jsystem.init_params, jax.random.PRNGKey(5))
    rng = np.random.RandomState(6)
    tree = jax.tree.map(lambda s: rng.rand(*s.shape).astype(np.float32) + 0.5, shapes)
    sd = from_jax_params(tree)
    assert {k.split(".")[0] for k in sd} == {"vae", "denoiser", "proscene", "output_scene",
                                             "image_encoder", "output_images"}
    system.load_state_dict(sd, strict=True)
    back = jax_params(system)
    for key in ("image_encoder", "output_images"):
        assert jax.tree.all(jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)),
                                         back[key], tree[key])), key


def test_unknown_settings_are_refused():
    data = SyntheticEgoDataset(B, T, scene_points=POINTS, seed=0)
    for kw, match in ((dict(condition=("text",)), "unknown conditions"),
                      (dict(dataset_name="kit"), "dataset_name"),
                      (dict(estimate="both"), "estimate"), (dict(data_type="quat"), "data_type")):
        with pytest.raises(ValueError, match=match):
            SeeMeSystem(SeeMeConfig(**SMALL, **kw), smpl.synthetic_smpl(32), data.mean, data.std,
                        device="cpu")


# --------------------------------------------------------------- data, CLI

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


def test_trainer_caches_image_features(tmp_path):
    """Stage 2 of `mld_egobody_image` on the CPU at a tiny size: the cache
    holds the ResNet50's features of every train and val sample (equal to
    the encoder's on the raw crops), batches carry them in place of the
    crops, the steps train `output_images` and leave the encoder bitwise
    alone."""
    from seeme_tpu_torch.train.__main__ import Trainer, parse_args

    tiny = ["model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
            "model.scene_points=64", "model.scene_feat_dim=32", "model.image_size=32",
            "train.feature_cache=True", "train.val_every_steps=1"]
    tr = Trainer(parse_args(["--preset", "mld_egobody_image", "--device", "cpu", "--batch_size",
                             "64", "--epochs", "1", "--out", str(tmp_path), *tiny]))
    before = {k: v.clone() for k, v in tr.system.state_dict().items()}
    assert tr.fill_feature_cache() > 0
    cached = tr.datamodule.train_set.extras["image_feats"]
    assert cached.shape == (256, 2048) and tr.datamodule.val_set.extras["image_feats"].shape == (64, 2048)
    raw = torch.as_tensor(tr.datamodule.train_set.image[:3])
    np.testing.assert_allclose(cached[:3], tr.system.image_features(raw).numpy(), rtol=0,
                               atol=1e-5 * float(np.abs(cached).max()))
    batch = next(tr.train_batches(0))
    assert "image" not in batch and "scene" not in batch and batch["image_feats"].shape == (64, 2048)
    calls = []
    tr.system.image_encoder.register_forward_hook(lambda *a: calls.append(1))
    tr.fit()
    assert calls == [] and np.isfinite(tr.history[0]["val"]["total"])
    after = tr.system.state_dict()
    for k, v in after.items():
        if k.startswith(("image_encoder.", "vae.", "proscene.")):
            assert torch.equal(v, before[k]), k
    assert not torch.equal(after["output_images.1.weight"], before["output_images.1.weight"])
