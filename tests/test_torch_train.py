"""The port's training path against the JAX package, on the CPU in f32.

Both packages get the same numpy batch and the same weights (a port state
dict moved through `tools/convert_checkpoint.py::convert_mld_checkpoint`),
with dropout 0 on both sides. The JAX package draws its noise from key
splits inside `vae_loss` and `diffusion_loss`; the tests re-derive those
draws from the same keys (`seeme_tpu/models/seeme.py:343`, `:383`, `:399`,
`:437`) and hand them to the port's losses as `draws`, while the JAX side
calls its real `vae_loss`/`diffusion_loss`. Gradients come from `jax.grad`
with `stop_gradient` on the frozen subtrees, as `seeme_tpu/train/loop.py:58-68`.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seeme_tpu.config import load_config
from seeme_tpu.config.build import seeme_config_from_yaml
from seeme_tpu.config.loader import Config
from seeme_tpu.core.smpl import synthetic_smpl as j_synthetic_smpl
from seeme_tpu.data import batch as j_batch
from seeme_tpu.data.egobody import EgoBodyDataModule as JEgoBody
from seeme_tpu.data.registry import SyntheticDataModule as JSyntheticDataModule
from seeme_tpu.diffusion.schedulers import DiffusionSchedule as JSchedule
from seeme_tpu.models.seeme import SeeMeConfig as JConfig
from seeme_tpu.models.seeme import SeeMeSystem as JSystem
from seeme_tpu.train import losses as j_losses
from seeme_tpu.train.loop import _make_step_body
from seeme_tpu.train.state import STAGE_TRAINABLE as J_STAGE_TRAINABLE
from seeme_tpu.train.state import create_train_state
from seeme_tpu.train.state import make_optimizer as j_make_optimizer
from seeme_tpu.train.state import step_lr_schedule as j_step_lr_schedule
from seeme_tpu_torch.config.egobody import PRESETS
from seeme_tpu_torch.convert import from_jax_params
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data import batch as t_batch
from seeme_tpu_torch.data.egobody import EgoBodyDataModule
from seeme_tpu_torch.data.registry import SyntheticDataModule, get_datamodule
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.diffusion.schedulers import DiffusionSchedule
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.nn.init import perturb_parameters_
from seeme_tpu_torch.train import checkpoint as ckpt
from seeme_tpu_torch.train import losses
from seeme_tpu_torch.train.__main__ import main
from seeme_tpu_torch.train.loop import train_step
from seeme_tpu_torch.train.state import STAGE_TRAINABLE, make_optimizer, set_stage, step_lr_schedule
from tools.convert_checkpoint import convert_mld_checkpoint

B, W, POINTS, T = 3, 32, 64, 60
SMALL = dict(latent_dim=(1, W), ff_size=16, num_layers=3, scene_points=POINTS,
             scene_feat_dim=W, dropout=0.0)
BOTH = ("interactee", "scene")
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
# a gradient that is zero but for f32 rounding (a bias added to every token
# before the softmax over tokens cancels) is held to this absolute bound
GRAD_FLOOR = 1e-8


def build(condition=BOTH, guidance=1.0, seed=1, predict_epsilon=True):
    data = SyntheticEgoDataset(B, T, scene_points=POINTS, seed=0)
    kw = dict(condition=condition, guidance_scale=guidance, predict_epsilon=predict_epsilon,
              **SMALL)
    system = SeeMeSystem(SeeMeConfig(**kw), synthetic_smpl(256), data.mean, data.std,
                         device="cpu", seed=seed)
    perturb_parameters_(system, torch.Generator().manual_seed(seed + 1))
    jsystem = JSystem(JConfig(**kw), j_synthetic_smpl(256), data.mean, data.std)
    return data, system, jsystem, jax_params(system)


def jax_params(system):
    """The JAX tree of the port's weights, in memory of its own (a CPU
    `jnp.asarray` may alias the numpy buffer, which the port's in-place
    updates would then change)."""
    return jax.tree.map(lambda a: jnp.array(a, copy=True), convert_mld_checkpoint(
        {k: v.detach().numpy().copy() for k, v in system.state_dict().items()}))


def jax_draws(jsystem, stage, batch, rng):
    """The draws `vae_loss` / `diffusion_loss` make from `rng`, re-derived."""
    shape = (B, 1, W)
    if stage == "vae":
        _, sample_rng = jax.random.split(rng)
        return {"eps": torch.tensor(np.asarray(jax.random.normal(sample_rng, shape)))}
    cond_rng, z_rng, t_rng, noise_rng, _ = jax.random.split(rng, 5)
    draws = {"eps": jax.random.normal(z_rng, shape),
             "noise": jax.random.normal(noise_rng, shape),
             "timesteps": jax.random.randint(t_rng, (B,), 0, 1000)}
    cfg = jsystem.cfg
    if cfg.guidance_scale > 1.0:
        if jsystem.use_interactee:
            cond_rng, mask_rng = jax.random.split(cond_rng)
            draws["mask_interactee"] = jax.random.uniform(mask_rng, (B, T, 75)) < cfg.guidance_uncondp
        if jsystem.use_scene:
            cond_rng, mask_rng = jax.random.split(cond_rng)
            draws["mask_scene"] = (jax.random.uniform(mask_rng, batch["scene"].shape)
                                   < cfg.guidance_uncondp)
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def jax_loss_and_grads(jsystem, stage):
    loss_fn = jsystem.vae_loss if stage == "vae" else jsystem.diffusion_loss
    trainable = J_STAGE_TRAINABLE[stage]

    def compute(params, batch, rng):
        params = {k: (v if k in trainable else jax.lax.stop_gradient(v)) for k, v in params.items()}
        return loss_fn(params, batch, rng)

    return jax.jit(jax.value_and_grad(compute, has_aux=True))


def batches(data, system, jsystem, params, cached):
    nb = data.batch(0, B)
    if not system.use_scene:
        nb.pop("scene")
    if cached:
        nb["scene_feats"] = np.array(jsystem.scene_features(params, jnp.asarray(nb["scene"])))
    return to_torch(nb, "cpu"), {k: jnp.asarray(v) for k, v in nb.items()}


LOSS_CASES = [("vae", (), 1.0, False, True), ("diffusion", BOTH, 1.0, True, True),
              ("diffusion", BOTH, 1.0, False, True), ("diffusion", BOTH, 2.5, False, True),
              ("diffusion", BOTH, 1.0, True, False)]
LOSS_IDS = ["vae", "diffusion-cached", "diffusion-raw", "diffusion-cfg2.5", "diffusion-x0"]


@pytest.mark.parametrize("stage,condition,guidance,cached,predict_epsilon", LOSS_CASES,
                         ids=LOSS_IDS)
def test_loss_and_gradients_match_jax(stage, condition, guidance, cached, predict_epsilon):
    """Every loss term within 1e-5 relative, and every trainable tensor's
    gradient within 1e-4 x its max |g|; frozen tensors get no gradient.
    `predict_epsilon=False` is the x0-prediction loss."""
    data, system, jsystem, params = build(condition, guidance, predict_epsilon=predict_epsilon)
    tb, jb = batches(data, system, jsystem, params, cached)
    rng = jax.random.PRNGKey(11)
    (jloss, jterms), jgrads = jax_loss_and_grads(jsystem, stage)(params, jb, rng)

    trainable = set_stage(system, stage)
    fn = system.vae_loss if stage == "vae" else system.diffusion_loss
    loss, terms = fn(tb, draws=jax_draws(jsystem, stage, jb, rng))
    loss.backward()
    assert set(terms) == set(jterms)
    for k, v in terms.items():
        np.testing.assert_allclose(v.item(), float(jterms[k]), rtol=LOSS_RTOL, err_msg=k)
    ref = from_jax_params(jax.tree.map(np.asarray, jgrads))
    ids = {id(p) for p in trainable}
    for name, p in system.named_parameters():
        if id(p) not in ids:
            assert p.grad is None, name
            continue
        g = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=max(GRAD_RTOL * float(np.abs(g).max()), GRAD_FLOOR), err_msg=name)
    if stage == "diffusion":  # output_scene trains through the cached and the raw route
        assert float(system.output_scene[1].weight.grad.abs().max()) > 0


def sd_numpy(system):
    return {k: v.detach().numpy().copy() for k, v in system.state_dict().items()}


@pytest.mark.parametrize("stage", ["vae", "diffusion"])
def test_optimizer_matches_optax(stage):
    """The same gradients through the port's AdamW and `make_optimizer`'s
    optax chain for 10 steps, 2 steps an epoch and a step size of 2 epochs
    (two decays of the learning rate): parameters within 1e-6, frozen
    tensors bitwise unchanged."""
    _, system, _, params = build()
    kw = dict(lr=1e-2, step_size_epochs=2, gamma=0.2, steps_per_epoch=2)
    optimizer, schedule = make_optimizer(stage, system, **kw)
    jopt = j_make_optimizer(stage, params, **kw)
    jstate = jopt.init(params)
    jupdate = jax.jit(jopt.update)
    before = sd_numpy(system)
    names = [n for n, p in system.named_parameters() if p.requires_grad]
    rng = np.random.RandomState(5)
    for count in range(10):
        grads = {k: np.zeros_like(v) for k, v in before.items()}
        grads.update({n: rng.randn(*before[n].shape).astype(np.float32) for n in names})
        for group in optimizer.param_groups:
            group["lr"] = schedule(count)
        for n, p in system.named_parameters():
            p.grad = torch.as_tensor(grads[n]) if p.requires_grad else None
        optimizer.step()
        jgrads = jax.tree.map(jnp.asarray, convert_mld_checkpoint(grads))
        updates, jstate = jupdate(jgrads, jstate, params)
        params = optax.apply_updates(params, updates)
    assert schedule(9) == pytest.approx(1e-2 * 0.2 ** 2)
    ref = from_jax_params(jax.tree.map(np.asarray, params))
    for k, v in system.state_dict().items():
        if k in names:
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
            assert not np.array_equal(v.numpy(), before[k]), k
        else:
            assert np.array_equal(v.numpy(), before[k]), k


@pytest.mark.parametrize("stage", ["vae", "diffusion"])
def test_five_train_steps_match_jax(stage):
    """Five whole train steps (the JAX step body with its own key splits,
    the port's `train_step` with those draws): loss trajectories within 1e-4
    relative."""
    data, system, jsystem, params = build(() if stage == "vae" else BOTH)
    tb, jb = batches(data, system, jsystem, params, cached=stage == "diffusion")
    kw = dict(lr=1e-3, step_size_epochs=2, gamma=0.2, steps_per_epoch=2)
    optimizer, schedule = make_optimizer(stage, system, **kw)
    jopt = j_make_optimizer(stage, params, **kw)
    jstep = jax.jit(_make_step_body(jsystem, stage, jopt))
    state = create_train_state(params, jopt, jax.random.PRNGKey(3))
    rng = state.rng
    ours, theirs = [], []
    for count in range(5):
        rng, step_rng = jax.random.split(rng)
        terms = train_step(system, stage, optimizer, schedule, count, tb,
                           draws=jax_draws(jsystem, stage, jb, step_rng))
        state, jterms = jstep(state, jb)
        ours.append(terms["total"])
        theirs.append(float(jterms["total"]))
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)


@pytest.mark.parametrize("stage", ["vae", "diffusion"])
def test_resume_is_bitwise(stage, tmp_path):
    """4 steps straight, against 2 steps, a checkpoint, a restore into a
    fresh system and 2 more: parameters and optimizer state bitwise equal
    (dropout on, so torch's default generator is restored too)."""
    data = SyntheticEgoDataset(B, T, scene_points=POINTS, seed=0)
    tb = to_torch(data.batch(0, B), "cpu")

    def fresh():
        cfg = dataclasses.replace(SeeMeConfig(**SMALL), dropout=0.1)
        system = SeeMeSystem(cfg, synthetic_smpl(256), data.mean, data.std, device="cpu", seed=1)
        optimizer, schedule = make_optimizer(stage, system, lr=1e-3, steps_per_epoch=2)
        return system, optimizer, schedule, torch.Generator().manual_seed(9)

    def run(parts, counts):
        for count in counts:
            train_step(*parts[:1], stage, parts[1], parts[2], count, tb, parts[3])

    torch.manual_seed(4)
    straight = fresh()
    run(straight, range(4))
    torch.manual_seed(4)
    first = fresh()
    run(first, range(2))
    path = ckpt.save_state(str(tmp_path), first[0], first[1], 2, 1, first[3])
    assert os.path.basename(path) == "2.pt"
    torch.rand(7)  # the restore must undo any later draw
    second = fresh()
    assert ckpt.restore_state(str(tmp_path), second[0], second[1], second[3]) == (2, 1)
    run(second, range(2, 4))
    for k, v in straight[0].state_dict().items():
        assert torch.equal(v, second[0].state_dict()[k]), k
    a, b = straight[1].state_dict()["state"], second[1].state_dict()["state"]
    assert a.keys() == b.keys()
    for i in a:
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k]), (i, k)


def test_pretrained_vae(tmp_path):
    """`load_pretrained_vae` grafts only `vae.*` from a stage-1 checkpoint,
    and raises on a checkpoint without it."""
    _, donor, _, _ = build(())
    optimizer, _ = make_optimizer("vae", donor)
    ckpt.save_state(str(tmp_path / "s1"), donor, optimizer, 7, 1)
    _, system, _, _ = build(BOTH, seed=5)
    before = {k: v.clone() for k, v in system.state_dict().items()}
    n = ckpt.load_pretrained_vae(str(tmp_path / "s1" / "checkpoints" / "latest"), system)
    assert n == len(donor.vae.state_dict())
    for k, v in system.state_dict().items():
        want = donor.state_dict()[k] if k.startswith("vae.") else before[k]
        assert torch.equal(v, want), k
    torch.save({"state_dict": {k: v for k, v in before.items() if not k.startswith("vae.")}},
               tmp_path / "no_vae.pt")
    with pytest.raises(KeyError, match="vae"):
        ckpt.load_pretrained_vae(str(tmp_path / "no_vae.pt"), system)


def test_checkpoint_paths(tmp_path):
    exp = tmp_path / "exp"
    (exp / "checkpoints").mkdir(parents=True)
    assert ckpt.latest_checkpoint_step(str(exp)) is None
    for step in (4, 12, 8):
        (exp / "checkpoints" / f"{step}.pt").write_bytes(b"")
    (exp / "checkpoints" / "12.pt.tmp").write_bytes(b"")
    assert ckpt.latest_checkpoint_step(str(exp)) == 12
    assert ckpt.resolve_latest(str(exp / "checkpoints" / "latest")) == str(exp / "checkpoints" / "12.pt")
    assert ckpt.resolve_latest(str(exp / "checkpoints" / "4.pt")) == str(exp / "checkpoints" / "4.pt")
    for spelling in (exp, exp / "checkpoints", exp / "checkpoints" / "8.pt",
                     exp / "checkpoints" / "latest"):
        assert ckpt.normalize_resume_dir(str(spelling)) == str(exp)
    numeric = tmp_path / "17"  # an experiment dir named by a number stays itself
    assert ckpt.normalize_resume_dir(str(numeric)) == str(numeric)
    assert ckpt.resume_scan(str(exp)) == (None, 12)
    (exp / "config.json").write_text("{}")
    assert ckpt.resume_scan(str(exp)) == (str(exp / "config.json"), 12)
    assert ckpt.clear_stale_steps(str(exp)) == 3
    assert ckpt.latest_checkpoint_step(str(exp)) is None


def test_step_lr_schedule_matches_jax():
    ours, theirs = step_lr_schedule(1e-4, 3, 0.2, 4), j_step_lr_schedule(1e-4, 3, 0.2, 4)
    for count in range(40):
        assert ours(count) == pytest.approx(float(theirs(count)), rel=1e-6), count
    assert STAGE_TRAINABLE == J_STAGE_TRAINABLE


def test_schedule_noise_matches_jax():
    ours, theirs = DiffusionSchedule(), JSchedule()
    rng = np.random.RandomState(6)
    x0, noise = rng.randn(4, 1, 8).astype(np.float32), rng.randn(4, 1, 8).astype(np.float32)
    t = np.array([0, 17, 500, 999])
    got = ours.add_noise(*map(torch.as_tensor, (x0, noise, t)))
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs.add_noise(x0, noise, t)),
                               rtol=1e-6, atol=1e-6)
    for step in (1, 981):
        got = ours.predict_x0(torch.as_tensor(noise), step, torch.as_tensor(x0))
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs.predict_x0(noise, step, x0)),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["smooth_l1", "mse", "kl_standard_normal"])
def test_loss_functions_match_jax(name):
    rng = np.random.RandomState(8)
    a, b = rng.randn(5, 7).astype(np.float32) * 2, rng.randn(5, 7).astype(np.float32)
    got = getattr(losses, name)(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.item(), float(getattr(j_losses, name)(a, b)), rtol=1e-6)


@pytest.mark.parametrize("sample_mean,fact", [(True, None), (False, None), (False, 0.5)],
                         ids=["mean", "draw", "fact"])
def test_reconstruct_matches_jax(sample_mean, fact):
    data, system, jsystem, params = build(())
    nb = data.batch(0, B)
    rng = jax.random.PRNGKey(2)
    eps = torch.as_tensor(np.asarray(jax.random.normal(rng, (B, 1, W))))
    got = system.reconstruct(to_torch(nb, "cpu"), eps=eps, sample_mean=sample_mean, fact=fact)
    want = jsystem.reconstruct(params, {k: jnp.asarray(v) for k, v in nb.items()}, rng,
                               sample_mean=sample_mean, fact=fact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


# ------------------------------------------------------------------ data

def jax_datamodule(condition, scene_points=16):
    cfg = Config({"DATASET_NAME": "egobody", "MOTION_LENGTH": T,
                  "model": Config({"condition": list(condition), "scene_points": scene_points})})
    return JSyntheticDataModule(cfg)


def same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        if isinstance(a, tuple):  # eval_batches: (batch, n_valid)
            assert a[1] == b[1]
            a, b = a[0], b[0]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("condition", [(), BOTH], ids=["none", "both"])
def test_synthetic_datamodule_matches_jax(condition):
    """Same arrays, statistics, batch order and padded eval batches."""
    ours, theirs = SyntheticDataModule(condition, T, scene_points=16), jax_datamodule(condition)
    np.testing.assert_array_equal(ours.mean, theirs.mean)
    np.testing.assert_array_equal(ours.std, theirs.std)
    assert ours.num_train == theirs.num_train == 256
    same_batches(ours.batches("train", 24, seed=3), theirs.batches("train", 24, seed=3))
    same_batches(ours.batches("val", 24, drop_last=False), theirs.batches("val", 24, drop_last=False))
    same_batches(t_batch.eval_batches(ours, "val", 24), j_batch.eval_batches(theirs, "val", 24))
    for a, b in zip(ours.batch_indices("train", 10, seed=1), theirs.batch_indices("train", 10, seed=1)):
        np.testing.assert_array_equal(a, b)
    assert ("scene" in ours.split_arrays("test")) == ("scene" in condition)


def test_attach_split_features_matches_jax():
    ours, theirs = SyntheticDataModule(BOTH, T, scene_points=16), jax_datamodule(BOTH)
    feats = np.random.RandomState(1).randn(64, 5).astype(np.float32)
    for dm in (ours, theirs):
        dm.attach_split_features("val", "scene_feats", feats)
    same_batches(ours.batches("val", 16), theirs.batches("val", 16))
    assert "scene" not in next(ours.batches("val", 16))
    with pytest.raises(ValueError, match="rows"):
        ours.attach_split_features("val", "scene_feats", feats[:3])


def test_pad_batch_matches_jax():
    batch = {"a": np.arange(6).reshape(3, 2), "b": ["x", "y", "z"], "c": {"d": np.ones((3, 1))}}
    (ours, n), (theirs, m) = t_batch.pad_batch(batch, 5), j_batch.pad_batch(batch, 5)
    assert n == m == 3
    np.testing.assert_array_equal(ours["a"], theirs["a"])
    assert ours["b"] == theirs["b"] == ["x", "y", "z", "z", "z"]
    np.testing.assert_array_equal(ours["c"]["d"], theirs["c"]["d"])
    assert t_batch.pad_batch(batch, 2) == (batch, 3)


def write_release(root, n=7):
    proc = root / "EgoBody" / "processed"
    proc.mkdir(parents=True)
    rng = np.random.RandomState(3)
    np.save(proc / "mean.npy", rng.randn(75).astype(np.float32))
    np.save(proc / "std.npy", rng.rand(75).astype(np.float32) + 0.5)
    for split in ("train", "val"):
        np.savez(proc / f"{split}.npz",
                 feats=rng.randn(n, T, 2, 72).astype(np.float32),
                 transl=rng.randn(n, 2, T, 3).astype(np.float32),
                 betas=rng.randn(n, 2, T, 10).astype(np.float32),
                 cam=rng.randn(n, T, 6).astype(np.float32),
                 length=np.full(n, T, np.int32),
                 scene=rng.randn(n, 16, 3).astype(np.float32),
                 image_crops=rng.randint(0, 255, (n, 2, 4, 4, 3)).astype(np.uint8))
    return root / "EgoBody"


def test_egobody_datamodule_matches_jax(tmp_path):
    """The release's processed shards: the same batches (random crop pick
    included) as the JAX module, cached features superseding the cloud, and
    `get_datamodule` choosing it over the synthetic data."""
    root = write_release(tmp_path)
    ours, theirs = EgoBodyDataModule(str(root)), JEgoBody(Config({"DATASET_NAME": "egobody"}), str(root))
    np.testing.assert_array_equal(ours.std, theirs.std)
    assert ours.num_train == theirs.num_train == 7
    same_batches(ours.batches("train", 3, seed=2), theirs.batches("train", 3, seed=2))
    same_batches(t_batch.eval_batches(ours, "val", 4), j_batch.eval_batches(theirs, "val", 4))
    feats = np.ones((7, 4), np.float32)
    ours.attach_split_features("train", "scene_feats", feats)
    theirs.attach_split_features("train", "scene_feats", feats)
    same_batches(ours.batches("train", 3), theirs.batches("train", 3))
    assert "scene" not in next(ours.batches("train", 3))
    assert isinstance(get_datamodule("egobody", root=str(tmp_path)), EgoBodyDataModule)
    assert isinstance(get_datamodule("egobody", root=str(tmp_path / "absent")), SyntheticDataModule)
    with pytest.raises(KeyError, match="gimo"):  # the error lists the registered datasets
        get_datamodule("babel")


# --------------------------------------------------------- presets, CLI

@pytest.mark.parametrize("preset,yaml_name", [("vae_egobody", "config_vae_egobody.yaml"),
                                              ("mld_egobody", "config_mld_egobody.yaml"),
                                              ("mld_egobody_image", "config_mld_egobody_image.yaml"),
                                              ("vae_gimo", "config_vae_gimo.yaml"),
                                              ("mld_gimo", "config_mld_gimo.yaml"),
                                              ("vae_interactee", "config_vae_interactee.yaml"),
                                              ("mld_interactee", "config_mld_interactee.yaml")])
def test_presets_match_the_yaml(preset, yaml_name):
    """Each preset field equals what `load_config` reads from its YAML
    (over base.yaml); the stage-1 checkpoint path is the port's own folder.
    `image_size` is the port's alone (the JAX package's crops are 224)."""
    root = os.path.join(os.path.dirname(__file__), "..", "configs")
    cfg = load_config(os.path.join(root, yaml_name))
    ref = seeme_config_from_yaml(cfg)
    p = PRESETS[preset]()
    for f in dataclasses.fields(p.model):
        if f.name == "loss":
            assert dataclasses.asdict(p.model.loss) == dataclasses.asdict(ref.loss)
        elif f.name == "image_size":
            assert p.model.image_size == 224
        elif f.name != "fused_variant":
            assert getattr(p.model, f.name) == getattr(ref, f.name), f.name
    t = p.train
    assert (t.stage, t.batch_size, t.end_epoch) == (cfg.TRAIN.STAGE, cfg.TRAIN.BATCH_SIZE,
                                                    cfg.TRAIN.END_EPOCH)
    assert (t.lr, t.step_size, t.gamma) == (float(cfg.TRAIN.OPTIM.LR), cfg.TRAIN.OPTIM.STEP_SIZE,
                                            cfg.TRAIN.OPTIM.GAMMA)
    assert (t.val_every_steps, t.save_checkpoint_epoch) == (cfg.LOGGER.VAL_EVERY_STEPS,
                                                            cfg.LOGGER.SACE_CHECKPOINT_EPOCH)
    assert (t.seed, p.name, p.dataset) == (cfg.SEED_VALUE, cfg.NAME, cfg.DATASET_NAME)
    if cfg.TRAIN.PRETRAINED_VAE:
        stage1 = cfg.TRAIN.PRETRAINED_VAE.split("/")[-3]  # s1_egobody or s1_gimo
        assert stage1 in ("s1_egobody", "s1_gimo")
        assert t.pretrained_vae.endswith(f"/{stage1}/checkpoints/latest")
    else:
        assert t.pretrained_vae == ""
    q = p.test
    assert (q.batch_size, q.replication_times, q.split) == (
        cfg.TEST.BATCH_SIZE, cfg.TEST.REPLICATION_TIMES, cfg.TEST.SPLIT)
    assert (q.checkpoint, q.mean, q.fact, q.count_time, q.save_predictions) == (
        cfg.TEST.CHECKPOINTS, cfg.TEST.MEAN, cfg.TEST.FACT, cfg.TEST.COUNT_TIME,
        cfg.TEST.SAVE_PREDICTIONS)


TINY = ["model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
        "model.scene_points=64", "model.scene_feat_dim=32", "train.val_every_steps=1"]


def test_cli_trains_both_stages_on_the_cpu(tmp_path):
    """`main(argv)` for one epoch of each stage at a tiny size: stage 1
    writes a checkpoint; stage 2 loads its VAE, fills the scene-feature
    cache, trains the denoiser and `output_scene` with the VAE and PointNet
    unchanged, validates and checkpoints."""
    s1 = main(["--preset", "vae_egobody", "--device", "cpu", "--batch_size", "32", "--epochs", "1",
               "--out", str(tmp_path / "s1"), *TINY])
    assert s1.step == 8 and s1.checkpoints == [str(tmp_path / "s1" / "checkpoints" / "8.pt")]
    assert all(np.isfinite(s["total"]) for s in s1.history[0]["steps"])
    assert set(s1.history[0]["val"]) == {"total", "recons_feature", "recons_joints",
                                          "recons_transl", "kl_motion"}
    s2 = main(["--preset", "mld_egobody", "--device", "cpu", "--batch_size", "32", "--epochs", "1",
               "--out", str(tmp_path / "s2"), "--pretrained_vae",
               str(tmp_path / "s1" / "checkpoints" / "latest"), "train.feature_cache=True", *TINY])
    assert s2.datamodule.train_set.extras["scene_feats"].shape == (256, 32)
    assert s2.datamodule.val_set.extras["scene_feats"].shape == (64, 32)
    vae = s1.system.vae.state_dict()
    for k, v in s2.system.vae.state_dict().items():
        assert torch.equal(v, vae[k]), k
    fresh = SeeMeSystem(s2.preset.model, synthetic_smpl(32), np.zeros(75), np.ones(75),
                        device="cpu", seed=s2.seed)
    for k, v in fresh.proscene.state_dict().items():
        assert torch.equal(v, s2.system.proscene.state_dict()[k]), k
    assert not torch.equal(fresh.output_scene[1].weight, s2.system.output_scene[1].weight)
    assert s2.step == 8 and np.isfinite(s2.history[0]["val"]["total"])
    assert os.path.exists(tmp_path / "s2" / "checkpoints" / "8.pt")
    assert os.path.exists(tmp_path / "s2" / "config.json")


def test_cli_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--preset", "vae_egobody", "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="FIELD=VALUE"):
        main(["--preset", "vae_egobody", "--device", "cpu", "--out", str(tmp_path), "lr=1"])
