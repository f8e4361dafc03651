"""Presets of the shipped action-to-motion configs, one a YAML file, over
`configs/base.yaml`, as `seeme_tpu/config/loader.py::load_config` merges
them and `seeme_tpu/config/build.py::build_a2m_system` reads them.

`vae_humanact12()` is `configs/config_vae_humanact12.yaml` (stage 1, the
motion VAE) and `mld_humanact12()` is `config_mld_humanact12.yaml` (stage
2, the latent denoiser on the action token); `vae_uestc()` and
`mld_uestc()` are the UESTC pair, the same model with 40 classes. The CLIs
take the classes and the width in features from the datamodule, as
`build_a2m_system` does. Each field names the line it comes from in the
HumanAct12 files (the stage-1 file one line lower than the stage-2 one: a
two-line header); each UESTC file is its HumanAct12 file's twin up to
`target: modules_humanact12`, which it has not, and one line higher after.
"""

from __future__ import annotations

from ..models.a2m import A2MConfig
from .egobody import OUT_ROOT, Preset, TestConfig, TrainConfig

# model (config_mld_humanact12.yaml:59-77): latent_dim [1, 256] (:64),
# ff_size 128, num_layers 5, num_head 1, droupout 0.1, guidance_scale 1.0
# (:70), guidance_uncondp 0.1, nfeats 150 (:72); 60 frames (DATASET.NUM_FRAMES
# unset: build_a2m_system's 60; MOTION_LENGTH 60, :7); 50 DDIM steps
# (modules/scheduler.yaml); LOSS LAMBDA_KL 1e-4, LAMBDA_REC 1.0 (:50-51)
A2M_MODEL = A2MConfig(nfeats=150, num_frames=60, num_classes=12, latent_dim=(1, 256),
                      ff_size=128, num_layers=5, num_heads=1, dropout=0.1, guidance_scale=1.0,
                      guidance_uncondp=0.1, num_inference_timesteps=50, lambda_kl=1e-4,
                      lambda_rec=1.0)


def vae_humanact12(dataset: str = "humanact12") -> Preset:
    """Stage 1: the VAE alone (`config_vae_humanact12.yaml`, TRAIN.STAGE vae, :12)."""
    return Preset(
        name=f"s1_{dataset}",                       # NAME (:4)
        dataset=dataset,                            # DATASET_NAME (:9)
        model=A2M_MODEL,
        # TRAIN (:11-24): batch 64, 3000 epochs, AdamW lr 1e-4, step 3000, gamma 0.2;
        # LOGGER SACE_CHECKPOINT_EPOCH / VAL_EVERY_STEPS 200 (:81, :83)
        train=TrainConfig(stage="vae", batch_size=64, end_epoch=3000, lr=1e-4, step_size=3000,
                          gamma=0.2),
        test=TestConfig(batch_size=64))             # TEST.BATCH_SIZE 64 (:41)


def mld_humanact12(dataset: str = "humanact12") -> Preset:
    """Stage 2: the denoiser on the action token (`config_mld_humanact12.yaml`,
    condition ['action'], :63), over the stage-1 VAE (TRAIN.PRETRAINED_VAE,
    :18), at the shipped guidance 1.0 (:70): the kernel sees B condition
    rows, not 2B."""
    return Preset(
        name=f"s2_{dataset}", dataset=dataset, model=A2M_MODEL,
        # TRAIN (:10-23): batch 64, 6000 epochs, AdamW lr 1e-4, step 6000, gamma 0.2;
        # LOGGER 200 / 200 (:80, :82)
        train=TrainConfig(stage="diffusion", batch_size=64, end_epoch=6000, lr=1e-4,
                          step_size=6000, gamma=0.2,
                          pretrained_vae=f"{OUT_ROOT}/s1_{dataset}/checkpoints/latest"),
        test=TestConfig(batch_size=64))             # TEST.BATCH_SIZE 64 (:40)


def vae_uestc() -> Preset:
    """`config_vae_uestc.yaml`: DATASET_NAME uestc (:9), 40 classes from the data."""
    return vae_humanact12("uestc")


def mld_uestc() -> Preset:
    """`config_mld_uestc.yaml`: over the UESTC stage-1 VAE (:18)."""
    return mld_humanact12("uestc")


A2M_PRESETS = {"vae_humanact12": vae_humanact12, "mld_humanact12": mld_humanact12,
               "vae_uestc": vae_uestc, "mld_uestc": mld_uestc}
