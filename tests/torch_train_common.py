"""Shared helpers of the training tests (`tests/test_torch_train*.py`).

The port's training path against the JAX package, on the CPU in f32.

Both packages get the same numpy batch and the same weights (a port state
dict moved through `tools/convert_checkpoint.py::convert_mld_checkpoint`),
with dropout 0 on both sides. The JAX package draws its noise from key
splits inside `vae_loss` and `diffusion_loss`; the tests re-derive those
draws from the same keys (`seeme_tpu/models/seeme.py:343`, `:383`, `:399`,
`:437`) and hand them to the port's losses as `draws`, while the JAX side
calls its real `vae_loss`/`diffusion_loss`. Gradients come from `jax.grad`
with `stop_gradient` on the frozen subtrees, as `seeme_tpu/train/loop.py:58-68`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from seeme_tpu.config.loader import Config
from seeme_tpu.core.smpl import synthetic_smpl as j_synthetic_smpl
from seeme_tpu.data.registry import SyntheticDataModule as JSyntheticDataModule
from seeme_tpu.models.seeme import SeeMeConfig as JConfig
from seeme_tpu.models.seeme import SeeMeSystem as JSystem
from seeme_tpu.train.state import STAGE_TRAINABLE as J_STAGE_TRAINABLE
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.nn.init import perturb_parameters_
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
    """The draws `vae_loss` / `diffusion_loss` make from `rng`, re-derived,
    at the batch's size."""
    B = batch["feats"].shape[0]
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


def sd_numpy(system):
    return {k: v.detach().numpy().copy() for k, v in system.state_dict().items()}


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


TINY = ["model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
        "model.scene_points=64", "model.scene_feat_dim=32", "train.val_every_steps=1"]
