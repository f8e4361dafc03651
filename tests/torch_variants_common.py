"""Shared helpers of the ego-variant tests (`tests/test_torch_variants*.py`).

The port's ego variants against the JAX package, on the CPU in f32: the
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
import torch

from seeme_tpu.core import rotations as jrot
from seeme_tpu.core import smpl as jsmpl
from seeme_tpu.models.seeme import SeeMeConfig as JConfig
from seeme_tpu.models.seeme import SeeMeSystem as JSystem
from seeme_tpu_torch.core import smpl
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.nn.init import init_parameters_, perturb_parameters_
from seeme_tpu_torch.nn.resnet import resnet50
from tools.convert_checkpoint import convert_mld_checkpoint, convert_resnet50

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


def port_resnet(seed=0):
    net = resnet50()
    g = torch.Generator().manual_seed(seed)
    init_parameters_(net, g)
    perturb_parameters_(net, g)
    randomize_batch_stats_(net, g)
    return net


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
