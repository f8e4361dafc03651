"""A loaded YAML config -> the port's configs and systems
(`seeme_tpu/config/build.py`).

`seeme_config_from_yaml`, `t2m_config_from_yaml` and `a2m_config_from_yaml`
read the keys the JAX builders read (`:29-59`, `:71-116`, `:118-144`, with
the reference's `droupout` spelling and `TRAIN.ABLATION`), with the same
defaults. `preset_from_yaml` adds the training and test settings the CLIs
read (`train.py`, `test.py`) and gives a `Preset`, the form the port's CLIs
and `config/presets.py::build` take, so `--cfg` and `--preset` run one
code path. Every key the JAX builder and CLIs read takes effect: the ego
config's `model.num_head`, `model.scheduler.eta` and `model.use_fused`
route its sampling (`models/seeme.py::SeeMeSystem.takes_kernel`), as
`model.use_fused` and `TEST.USE_FUSED` route the text- and
action-to-motion models'; `TRAIN.RESUME` and `LOGGER.LOG_EVERY_STEPS` reach
the train CLI, `TEST.EVALUATOR_HIDDEN` / `EVALUATOR_LAYERS` the action
evaluator. None is dropped.
"""

from __future__ import annotations

import os
from pathlib import PurePosixPath
from typing import Any, Optional, Tuple

import torch

from ..core.smpl import SmplModel, smpl_body
from ..models.a2m import A2MConfig
from ..models.seeme import SeeMeConfig
from ..models.t2m import T2MConfig
from ..train.losses import LossWeights
from .egobody import OUT_ROOT, Preset, TestConfig, TrainConfig
from .loader import Config

T2M_DATASETS = ("humanml3d", "kit")
A2M_DATASETS = ("humanact12", "uestc")


def _model_get(model: Config, *names: str, default: Any = None) -> Any:
    for n in names:
        if n in model:
            return model[n]
    return default


def loss_weights_from_config(cfg: Config) -> LossWeights:
    loss = cfg.get("LOSS") or {}
    return LossWeights(lambda_rec=float(loss.get("LAMBDA_REC", 1.0)),
                       lambda_joint=float(loss.get("LAMBDA_JOINT", 1.0)),
                       lambda_root=float(loss.get("LAMBDA_ROOT", 1.0)),
                       lambda_kl=float(loss.get("LAMBDA_KL", 1e-4)))


def seeme_config_from_yaml(cfg: Config) -> SeeMeConfig:
    """The ego system's config (`seeme_tpu/config/build.py:29-59`)."""
    model, abl = cfg.model, cfg.TRAIN.ABLATION
    sched = model.get("scheduler") or {}
    return SeeMeConfig(
        dataset_name=cfg.get("DATASET_NAME", "egobody"),
        estimate=cfg.get("ESTIMATE", "wearer"),
        data_type=cfg.get("DATA_TYPE", "angle"),
        predict_transl=bool(abl.get("PREDICT_TRANSL", True)),
        motion_length=int(cfg.get("MOTION_LENGTH", 60)),
        condition=tuple(model.get("condition") or []),
        latent_dim=tuple(model.get("latent_dim", [1, 256])),
        ff_size=int(model.get("ff_size", 128)),
        num_layers=int(model.get("num_layers", 5)),
        num_heads=int(_model_get(model, "num_head", "num_heads", default=1)),
        # 'droupout' is the reference's yaml key spelling (config_mld_egobody.yaml:119)
        dropout=float(_model_get(model, "droupout", "dropout", default=0.1)),
        guidance_scale=float(model.get("guidance_scale", 1.0)),
        guidance_uncondp=float(model.get("guidance_uncondp", 0.1)),
        predict_epsilon=bool(abl.get("PREDICT_EPSILON", True)),
        md_trans=bool(abl.get("MD_TRANS", False)),
        mlp_dist=bool(abl.get("MLP_DIST", False)),
        num_inference_timesteps=int(sched.get("num_inference_timesteps", 50)),
        eta=float(sched.get("eta", 0.0)),
        scene_points=int(model.get("scene_points", 20000)),
        scene_feat_dim=int(model.get("scene_feat_dim", 512)),
        use_fused=bool(model.get("use_fused", True)),
        fused_variant=str(model.get("fused_variant", "loop")),
        loss=loss_weights_from_config(cfg),
    )


def t2m_config_from_yaml(cfg: Config, nfeats: Optional[int] = None) -> T2MConfig:
    """The text-to-motion config (`seeme_tpu/config/build.py:71-116`); the
    width in features from the data when given, as the JAX builder takes it
    from the datamodule."""
    model, abl = cfg.model, cfg.TRAIN.ABLATION
    sched = model.get("scheduler") or {}
    loss = cfg.get("LOSS") or {}
    te = cfg.select("model.text_encoder.params", {}) or {}
    return T2MConfig(
        nfeats=int(nfeats if nfeats is not None else model.get("nfeats", 263)),
        max_len=int(cfg.select("DATASET.SAMPLER.MAX_LEN", 196)),
        min_len=int(cfg.select("DATASET.SAMPLER.MIN_LEN", 40)),
        latent_dim=tuple(model.get("latent_dim", [1, 256])),
        ff_size=int(model.get("ff_size", 128)),
        num_layers=int(model.get("num_layers", 5)),
        num_heads=int(_model_get(model, "num_head", "num_heads", default=1)),
        dropout=float(_model_get(model, "droupout", "dropout", default=0.1)),
        text_encoded_dim=int(cfg.select("model.denoiser.params.text_encoded_dim", 768) or 768),
        guidance_scale=float(model.get("guidance_scale", 7.5)),
        guidance_uncondp=float(model.get("guidance_uncondp", 0.1)),
        num_inference_timesteps=int(sched.get("num_inference_timesteps", 50)),
        lambda_kl=float(loss.get("LAMBDA_KL", 1e-4)),
        lambda_rec=float(loss.get("LAMBDA_REC", 1.0)),
        lambda_joint=float(loss.get("LAMBDA_JOINT", 1.0)),
        vae_type=str(model.get("vae_type", "mld")),
        mlp_dist=bool(abl.get("MLP_DIST", False)),
        arch=str(cfg.select("model.denoiser.params.arch", "trans_enc") or "trans_enc"),
        text_encoder_path=str(te.get("modelpath") or cfg.select("model.clip_path", "") or ""),
        last_hidden_state=bool(te.get("last_hidden_state", False)),
        use_fused=bool(model.get("use_fused", True)),
    )


def a2m_config_from_yaml(cfg: Config, nfeats: Optional[int] = None,
                         num_classes: Optional[int] = None) -> A2MConfig:
    """The action-to-motion config (`seeme_tpu/config/build.py:118-144`);
    width and classes from the data when given."""
    model = cfg.model
    sched = model.get("scheduler") or {}
    loss = cfg.get("LOSS") or {}
    return A2MConfig(
        nfeats=int(nfeats if nfeats is not None else model.get("nfeats", 150)),
        num_frames=int(cfg.select("DATASET.NUM_FRAMES", 60)),
        num_classes=int(num_classes if num_classes is not None else 12),
        latent_dim=tuple(model.get("latent_dim", [1, 256])),
        ff_size=int(model.get("ff_size", 128)),
        num_layers=int(model.get("num_layers", 5)),
        num_heads=int(_model_get(model, "num_head", "num_heads", default=1)),
        dropout=float(_model_get(model, "droupout", "dropout", default=0.1)),
        guidance_scale=float(model.get("guidance_scale", 7.5)),
        guidance_uncondp=float(model.get("guidance_uncondp", 0.1)),
        num_inference_timesteps=int(sched.get("num_inference_timesteps", 50)),
        lambda_kl=float(loss.get("LAMBDA_KL", 1e-4)),
        lambda_rec=float(loss.get("LAMBDA_REC", 1.0)),
        use_fused=bool(model.get("use_fused", True)),
    )


def _port_checkpoint(path: str) -> str:
    """A YAML's stage-1 checkpoint path (`./experiments/mld/<name>/checkpoints/latest`)
    in the port's own experiment folders (`<OUT_ROOT>/<name>/checkpoints/latest`):
    the JAX package's checkpoints are not the port's."""
    if not path:
        return ""
    parts = PurePosixPath(path).parts
    return f"{OUT_ROOT}/" + "/".join(parts[-3:])


def preset_from_yaml(cfg: Config) -> Preset:
    """The `Preset` a loaded config describes: its model config, the
    training settings `train.py` reads and the test settings `test.py`
    reads."""
    name = str(cfg.get("DATASET_NAME", "egobody"))
    if name in T2M_DATASETS:
        model = t2m_config_from_yaml(cfg)
    elif name in A2M_DATASETS:
        model = a2m_config_from_yaml(cfg)
    else:
        model = seeme_config_from_yaml(cfg)
    tr, optim, logger = cfg.TRAIN, cfg.TRAIN.OPTIM, cfg.get("LOGGER") or {}
    cache = tr.get("FEATURE_CACHE", tr.get("SCENE_CACHE"))
    train = TrainConfig(
        stage=str(tr.get("STAGE", "diffusion")), batch_size=int(tr.BATCH_SIZE),
        end_epoch=int(tr.END_EPOCH), lr=float(optim.LR), step_size=int(optim.STEP_SIZE),
        gamma=float(optim.GAMMA), pretrained_vae=_port_checkpoint(str(tr.get("PRETRAINED_VAE") or "")),
        val_every_steps=int(logger.get("VAL_EVERY_STEPS", 200)),
        save_checkpoint_epoch=int(logger.get("SACE_CHECKPOINT_EPOCH", 200)),
        feature_cache=None if cache is None else bool(cache),
        device_data=None if tr.get("DEVICE_DATA") is None else bool(tr.DEVICE_DATA),
        steps_per_dispatch=(None if tr.get("STEPS_PER_DISPATCH") is None
                            else int(tr.STEPS_PER_DISPATCH)),
        device_data_max_gb=float(tr.get("DEVICE_DATA_MAX_GB", 4.0)),
        resume=str(tr.get("RESUME") or ""),
        log_every_steps=int(logger.get("LOG_EVERY_STEPS", 1)),
        seed=int(cfg.get("SEED_VALUE", 1234)))
    te = cfg.get("TEST") or {}
    fact = te.get("FACT", 1.0)
    test = TestConfig(
        batch_size=int(te.get("BATCH_SIZE", 64)),
        replication_times=int(te.get("REPLICATION_TIMES", 1)),
        split=str(te.get("SPLIT", "test")), checkpoint=str(te.get("CHECKPOINTS") or ""),
        mean=bool(te.get("MEAN", False)), fact=float(1.0 if fact is None else fact),
        count_time=bool(te.get("COUNT_TIME", False)),
        save_predictions=bool(te.get("SAVE_PREDICTIONS", False)), mm=bool(te.get("MM", False)),
        mm_num_samples=int(te.get("MM_NUM_SAMPLES", 100)),
        mm_num_repeats=int(te.get("MM_NUM_REPEATS", 30)),
        mm_num_times=int(te.get("MM_NUM_TIMES", 10)),
        evaluator_dir=str(te.get("T2M_EVALUATOR_DIR") or ""),
        word_vectorizer_path=str(cfg.select("DATASET.WORD_VERTILIZER_PATH", "") or ""),
        evaluator_checkpoint=str(te.get("EVALUATOR_CHECKPOINT") or ""),
        use_fused=None if te.get("USE_FUSED") is None else bool(te.get("USE_FUSED")),
        evaluator_hidden=int(te.get("EVALUATOR_HIDDEN", 128)),
        evaluator_layers=int(te.get("EVALUATOR_LAYERS", 2)))
    return Preset(name=str(cfg.get("NAME", name)), model=model, train=train, dataset=name,
                  test=test, smpl_path=smpl_path_of(cfg), debug=bool(cfg.get("DEBUG", False)))


def smpl_path_of(cfg: Config) -> str:
    """`model.smpl_path` when that file exists, else empty."""
    path = str(cfg.select("model.smpl_path", "") or "")
    return path if path and os.path.exists(path) else ""


def load_smpl_or_synthetic(cfg: Config) -> SmplModel:
    """The configured SMPL body model, or the deterministic synthetic one
    (`synthetic_smpl(6890)`) when the file is absent, as
    `seeme_tpu/config/build.py:61-68` falls back."""
    return smpl_body(smpl_path_of(cfg))


def build_system(cfg: Config, device: torch.device) -> Tuple[Preset, Any, Any]:
    """(preset, datamodule, system) of a loaded config, as
    `seeme_tpu/config/build.py:146-162` with `get_datamodule`: the ego,
    text-to-motion or action-to-motion system by DATASET_NAME, seeded with
    SEED_VALUE, on the configured SMPL body (the synthetic one without the
    file)."""
    from .presets import build

    preset = preset_from_yaml(cfg)
    return (preset, *build(preset, device))
