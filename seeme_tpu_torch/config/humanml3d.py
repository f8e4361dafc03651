"""Presets of the shipped text-to-motion configs, one a YAML file, over
`configs/base.yaml` and the module files, as
`seeme_tpu/config/loader.py::load_config` merges them.

`vae_humanml3d()` is `configs/config_vae_humanml3d.yaml` (stage 1, the
motion VAE), `mld_humanml3d()` is `config_mld_humanml3d.yaml` (stage 2, the
latent denoiser on the text) and `novae_humanml3d()` is
`config_novae_humanml3d.yaml` (diffusion over the features, no VAE, the
`trans_dec` denoiser of `configs/modules_novae/denoiser.yaml`). KIT runs
the same presets with the `dataset=kit` override; the CLIs then take its
251 features from the datamodule, as `build_t2m_system` does. Each field
names the line it comes from.
"""

from __future__ import annotations

from .egobody import OUT_ROOT, Preset, TestConfig, TrainConfig
from ..models.t2m import T2MConfig


def vae_humanml3d() -> Preset:
    """Stage 1: the VAE alone (TRAIN.STAGE vae, :11)."""
    return Preset(
        name="s1_humanml3d",                        # NAME (:3)
        dataset="humanml3d",                        # DATASET_NAME (:8)
        # model (:59-76): latent_dim [1, 256], ff_size 128, num_layers 5,
        # num_head 1, droupout 0.1, guidance_scale 1.0, guidance_uncondp
        # 0.1, nfeats 263; text_encoded_dim 256 (configs/modules/denoiser.yaml:3),
        # arch trans_enc (:11); 50 DDIM steps (modules/scheduler.yaml);
        # LOSS LAMBDA_KL 1e-4, LAMBDA_REC 1.0 (:50-51), LAMBDA_JOINT 1.0
        # (base.yaml:72); MLP_DIST false (base.yaml:25); the text encoder's
        # modelpath none, pooled (modules/text_encoder.yaml)
        model=T2MConfig(latent_dim=(1, 256), ff_size=128, num_layers=5, num_heads=1,
                        dropout=0.1, text_encoded_dim=256, guidance_scale=1.0,
                        guidance_uncondp=0.1, num_inference_timesteps=50, lambda_kl=1e-4,
                        lambda_rec=1.0, lambda_joint=1.0, vae_type="mld", arch="trans_enc"),
        # TRAIN (:10-24): batch 64, 3000 epochs, AdamW lr 1e-4, step 3000, gamma 0.2
        train=TrainConfig(stage="vae", batch_size=64, end_epoch=3000, lr=1e-4, step_size=3000,
                          gamma=0.2),
        # TEST.BATCH_SIZE 64 (:40); COUNT_TIME, MM_* from base.yaml:46-50
        test=TestConfig(batch_size=64),
    )


def mld_humanml3d() -> Preset:
    """Stage 2: the denoiser on the pooled text (condition ['text'], :62),
    over the stage-1 VAE (TRAIN.PRETRAINED_VAE, :18), at guidance 1.0
    (:69): the kernel sees B condition rows, not 2B."""
    p = vae_humanml3d()
    return Preset(
        name="s2_humanml3d", dataset="humanml3d", model=p.model,
        train=TrainConfig(stage="diffusion", batch_size=64, end_epoch=6000, lr=1e-4,
                          step_size=6000, gamma=0.2,
                          pretrained_vae=f"{OUT_ROOT}/s1_humanml3d/checkpoints/latest"),
        test=TestConfig(batch_size=64))


def novae_humanml3d() -> Preset:
    """Diffusion over the padded features, no VAE (vae_type 'no', :61)."""
    return Preset(
        name="novae_humanml3d", dataset="humanml3d",
        # model (:58-74): latent_dim [1, 512], ff_size 1024, num_layers 9,
        # num_head 4, droupout 0.1, guidance_scale 7.5, guidance_uncondp 0.1;
        # text_encoded_dim 768 and arch trans_dec (modules_novae/denoiser.yaml:3, :11)
        model=T2MConfig(latent_dim=(1, 512), ff_size=1024, num_layers=9, num_heads=4,
                        dropout=0.1, text_encoded_dim=768, guidance_scale=7.5,
                        guidance_uncondp=0.1, num_inference_timesteps=50, lambda_kl=1e-4,
                        lambda_rec=1.0, lambda_joint=1.0, vae_type="no", arch="trans_dec"),
        # TRAIN (:9-26): batch 64, 2000 epochs, lr 1e-4, step 2000, gamma 0.2
        train=TrainConfig(stage="diffusion", batch_size=64, end_epoch=2000, lr=1e-4,
                          step_size=2000, gamma=0.2),
        test=TestConfig(batch_size=32))             # TEST.BATCH_SIZE 32 (:38)


T2M_PRESETS = {"vae_humanml3d": vae_humanml3d, "mld_humanml3d": mld_humanml3d,
               "novae_humanml3d": novae_humanml3d}
