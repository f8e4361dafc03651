"""The port's training path against the JAX package, on the CPU in f32.

Both packages get the same numpy batch and the same weights (a port state
dict moved through `tools/convert_checkpoint.py::convert_mld_checkpoint`),
with dropout 0 on both sides. The JAX package draws its noise from key
splits inside `vae_loss` and `diffusion_loss`; the tests re-derive those
draws from the same keys (`seeme_tpu/models/seeme.py:343`, `:383`, `:399`,
`:437`) and hand them to the port's losses as `draws`, while the JAX side
calls its real `vae_loss`/`diffusion_loss`. Gradients come from `jax.grad`
with `stop_gradient` on the frozen subtrees, as `seeme_tpu/train/loop.py:58-68`.

The losses, gradients, optimizer, schedules, data and presets; the
trajectories and checkpoints are in `test_torch_train_steps.py`, the CLI in
`test_torch_train_cli.py`, the helpers in `torch_train_common.py`.
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
from seeme_tpu.data import batch as j_batch
from seeme_tpu.data.egobody import EgoBodyDataModule as JEgoBody
from seeme_tpu.diffusion.schedulers import DiffusionSchedule as JSchedule
from seeme_tpu.train import losses as j_losses
from seeme_tpu.train.state import (
    STAGE_TRAINABLE as J_STAGE_TRAINABLE,
    make_optimizer as j_make_optimizer,
    step_lr_schedule as j_step_lr_schedule,
)
from seeme_tpu_torch.config.egobody import PRESETS
from seeme_tpu_torch.convert import from_jax_params
from seeme_tpu_torch.data import batch as t_batch
from seeme_tpu_torch.data.egobody import EgoBodyDataModule
from seeme_tpu_torch.data.registry import SyntheticDataModule, get_datamodule
from seeme_tpu_torch.data.synthetic import to_torch
from seeme_tpu_torch.diffusion.schedulers import DiffusionSchedule
from seeme_tpu_torch.train import losses
from seeme_tpu_torch.train.state import (
    STAGE_TRAINABLE,
    make_optimizer,
    set_stage,
    step_lr_schedule,
)
from tools.convert_checkpoint import convert_mld_checkpoint
from torch_train_common import (
    B,
    batches,
    BOTH,
    build,
    GRAD_FLOOR,
    GRAD_RTOL,
    jax_datamodule,
    jax_draws,
    jax_loss_and_grads,
    LOSS_CASES,
    LOSS_IDS,
    LOSS_RTOL,
    same_batches,
    sd_numpy,
    T,
    W,
    write_release,
)
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)


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
