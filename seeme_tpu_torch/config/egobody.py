"""Presets of the EgoBody main path's two training stages.

`vae_egobody()` is `configs/config_vae_egobody.yaml` (stage 1, the motion
VAE) and `mld_egobody()` is `configs/config_mld_egobody.yaml` (stage 2, the
latent denoiser on interactee + scene), each over `configs/base.yaml`, as
`seeme_tpu/config/loader.py::load_config` merges them. The port takes
presets and not the YAML files: the card's machine has no YAML reader. Each
field below names the YAML line it comes from.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..models.seeme import SeeMeConfig
from ..train.losses import LossWeights

OUT_ROOT = "./experiments/torch"  # the port's experiment folders (`<OUT_ROOT>/<name>`)


@dataclass(frozen=True)
class TrainConfig:
    stage: str                  # TRAIN.STAGE
    batch_size: int = 64        # TRAIN.BATCH_SIZE (config_*_egobody.yaml:14)
    end_epoch: int = 3000       # TRAIN.END_EPOCH (:15)
    lr: float = 1e-4            # TRAIN.OPTIM.LR (:21)
    step_size: int = 3000       # TRAIN.OPTIM.STEP_SIZE, in epochs (:22)
    gamma: float = 0.2          # TRAIN.OPTIM.GAMMA (:23)
    pretrained_vae: str = ""    # TRAIN.PRETRAINED_VAE (:18)
    # LOGGER.VAL_EVERY_STEPS and SACE_CHECKPOINT_EPOCH (config_*_egobody.yaml:79-81),
    # both counted in epochs, as train.py reads them
    val_every_steps: int = 200
    save_checkpoint_epoch: int = 200
    # TRAIN.FEATURE_CACHE (train.py:185-236): cache the frozen PointNet's
    # features once per sample in stage 2; None = on the card only
    feature_cache: Optional[bool] = None
    seed: int = 1234            # SEED_VALUE (base.yaml:3)


@dataclass(frozen=True)
class Preset:
    name: str                   # NAME (:3), the experiment folder's name
    model: SeeMeConfig
    train: TrainConfig
    dataset: str = "egobody"    # DATASET_NAME (:8)


# LOSS (config_*_egobody.yaml:47-57; LAMBDA_JOINT from base.yaml:72)
EGOBODY_LOSS = LossWeights(lambda_rec=1.0, lambda_joint=1.0, lambda_root=1.0, lambda_kl=1e-4)


def vae_egobody() -> Preset:
    """Stage 1: the motion VAE alone, no condition (`condition: []`, :62)."""
    return Preset(
        name="s1_egobody",
        # model: latent_dim [1, 256], ff_size 128, num_layers 5, droupout
        # 0.1, guidance 1.0, uncondp 0.1, scene_points 20000, scene_feat_dim
        # 512 (:59-76); the denoiser is built but does not train in this stage
        model=SeeMeConfig(condition=(), dropout=0.1, guidance_scale=1.0, guidance_uncondp=0.1,
                          loss=EGOBODY_LOSS),
        train=TrainConfig(stage="vae", end_epoch=3000, step_size=3000),
    )


def mld_egobody() -> Preset:
    """Stage 2: the denoiser on the interactee and scene tokens (:62), with
    the stage-1 VAE loaded and frozen."""
    return Preset(
        name="s2_scene_interactee",
        model=SeeMeConfig(condition=("interactee", "scene"), dropout=0.1, guidance_scale=1.0,
                          guidance_uncondp=0.1, loss=EGOBODY_LOSS),
        train=TrainConfig(stage="diffusion", end_epoch=6000, step_size=6000,
                          pretrained_vae=f"{OUT_ROOT}/s1_egobody/checkpoints/latest"),
    )


PRESETS = {"vae_egobody": vae_egobody, "mld_egobody": mld_egobody}
