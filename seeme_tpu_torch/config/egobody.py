"""Presets of the shipped ego configs, one a YAML file.

`vae_egobody()` is `configs/config_vae_egobody.yaml` (stage 1, the motion
VAE) and `mld_egobody()` is `configs/config_mld_egobody.yaml` (stage 2, the
latent denoiser on interactee + scene), each over `configs/base.yaml`, as
`seeme_tpu/config/loader.py::load_config` merges them; the other five are
the paper's image-conditioned SEE-ME (`config_mld_egobody_image.yaml`),
GIMO (`config_{vae,mld}_gimo.yaml`) and the interactee-only pair
(`config_{vae,mld}_interactee.yaml`). The port takes presets and not the
YAML files: the card's machine has no YAML reader. Each field names the YAML
line it comes from; the five later files keep `config_*_egobody.yaml`'s
layout line for line (the image file one line lower from its third line
on), so the lines cited for the EgoBody presets hold for them too.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..models.seeme import SeeMeConfig
from ..train.losses import LossWeights

# the port's experiment folders, `<OUT_ROOT>/<name>`: the shipped YAMLs'
# `<FOLDER>/torch/<model_type>` (`utils/logger.py::create_experiment_dir`)
OUT_ROOT = "./experiments/torch/mld"


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
    # TRAIN.DEVICE_DATA (train.py:283-285): keep the train split on the
    # device and gather each batch there; None = on the card only
    device_data: Optional[bool] = None
    # TRAIN.STEPS_PER_DISPATCH (train.py:252-255): steps between two fetches
    # of the loss terms; None = 8 on the card, 1 elsewhere
    steps_per_dispatch: Optional[int] = None
    # TRAIN.DEVICE_DATA_MAX_GB (train.py:313): the largest split kept on the device
    device_data_max_gb: float = 4.0
    # TRAIN.RESUME (config_*_egobody.yaml:17, train.py:155-178): an experiment
    # dir (or its checkpoints/ dir, a step or `latest` in it) to resume
    # from; empty = a fresh run. The CLI's --resume overrides it
    resume: str = ""
    # LOGGER.LOG_EVERY_STEPS (:80): every N-th epoch's line, counted in
    # epochs as train.py:389 reads it
    log_every_steps: int = 1
    seed: int = 1234            # SEED_VALUE (base.yaml:3)


@dataclass(frozen=True)
class TestConfig:
    """The evaluation settings `test.py` reads (TEST, :36-43 and base.yaml:39-66)."""

    batch_size: int = 64        # TEST.BATCH_SIZE (:40)
    replication_times: int = 1  # TEST.REPLICATION_TIMES (:41)
    split: str = "test"         # TEST.SPLIT (:39): "test" applies the test-split filter
    checkpoint: str = ""        # TEST.CHECKPOINTS (:37); empty = the seeded random init
    mean: bool = False          # TEST.MEAN (base.yaml:52): stage 1 decodes the mean latent
    fact: float = 1.0           # TEST.FACT (base.yaml:54): stage 1's eps scale
    count_time: bool = False    # TEST.COUNT_TIME (base.yaml:46)
    save_predictions: bool = False  # TEST.SAVE_PREDICTIONS (base.yaml:45)
    # the text-to-motion evaluation's (`test.py:222-364`): TEST.MM turns the
    # MultiModality pass on; its samples, repeats and pair draws
    # (base.yaml:48-50); the TM2T evaluator's weights (TEST.T2M_EVALUATOR_DIR)
    # and GloVe files (DATASET.WORD_VERTILIZER_PATH), empty = random init
    # and hashed word vectors
    mm: bool = False
    mm_num_samples: int = 100
    mm_num_repeats: int = 30
    mm_num_times: int = 10
    evaluator_dir: str = ""
    word_vectorizer_path: str = ""
    # the action-to-motion evaluation's (`test.py:365-450`): the recognition
    # model's weights under the reference's keys (TEST.EVALUATOR_CHECKPOINT),
    # empty = its seeded random init
    evaluator_checkpoint: str = ""
    # TEST.USE_FUSED (`test.py:73-87`): true samples through the fused DDIM
    # kernel, false through the `ddim_sample` loop; None (the key absent)
    # keeps the model's `use_fused`, the kernel as shipped. test.py's own
    # default is false
    use_fused: Optional[bool] = None
    # TEST.EVALUATOR_HIDDEN / EVALUATOR_LAYERS (`test.py:397-401`): the
    # HumanAct12 recognition GRU's width and depth
    evaluator_hidden: int = 128
    evaluator_layers: int = 2


@dataclass(frozen=True)
class Preset:
    name: str                   # NAME (:3), the experiment folder's name
    model: SeeMeConfig          # or a T2MConfig or A2MConfig (`config/humanml3d.py`, `a2m.py`)
    train: TrainConfig
    dataset: str = "egobody"    # DATASET_NAME (:8)
    test: TestConfig = field(default_factory=TestConfig)
    # model.smpl_path (:73) when that file exists (`config/build.py::smpl_path_of`);
    # empty = the synthetic body, as a preset names no file
    smpl_path: str = ""
    # DEBUG (base.yaml:4; false in every shipped top-level YAML): the small
    # splits of `data/registry.py::get_datamodule(debug=True)`
    debug: bool = False


# LOSS (config_*_egobody.yaml:47-57; LAMBDA_JOINT from base.yaml:72)
EGOBODY_LOSS = LossWeights(lambda_rec=1.0, lambda_joint=1.0, lambda_root=1.0, lambda_kl=1e-4)


def vae_egobody() -> Preset:
    """Stage 1: the motion VAE alone, no condition (`condition: []`, :62)."""
    return Preset(
        name="s1_egobody",
        # model: latent_dim [1, 256], ff_size 128, num_layers 5, droupout
        # 0.1, guidance 1.0, uncondp 0.1, scene_points 20000, scene_feat_dim
        # 512 (:59-76); the denoiser is built but does not train in this
        # stage, the token-concat stack of MD_TRANS false (base.yaml:31, :28)
        model=SeeMeConfig(condition=(), dropout=0.1, guidance_scale=1.0, guidance_uncondp=0.1,
                          md_trans=False, loss=EGOBODY_LOSS),
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


def mld_egobody_image() -> Preset:
    """The paper's SEE-ME: stage 2 on the interactee, scene and egocentric
    image tokens (`config_mld_egobody_image.yaml:63`), the frozen ResNet50
    beside the frozen PointNet, over the EgoBody stage-1 VAE (:19)."""
    p = mld_egobody()
    return dataclasses.replace(
        p, name="s2_scene_interactee_image",
        model=dataclasses.replace(p.model, condition=("interactee", "scene", "image")))


def vae_gimo() -> Preset:
    """GIMO stage 1 (`config_vae_gimo.yaml`: DATASET_NAME gimo :8, nfeats 69
    and njoints 21 :71-72, which `SeeMeConfig.nfeats` derives)."""
    p = vae_egobody()
    return dataclasses.replace(p, name="s1_gimo", dataset="gimo",
                               model=dataclasses.replace(p.model, dataset_name="gimo"))


def mld_gimo() -> Preset:
    """GIMO stage 2 on interactee + scene (`config_mld_gimo.yaml`), over
    the GIMO stage-1 VAE (:18)."""
    p = mld_egobody()
    return dataclasses.replace(
        p, name="s2_scene_interactee_gimo", dataset="gimo",
        model=dataclasses.replace(p.model, dataset_name="gimo"),
        train=dataclasses.replace(p.train, pretrained_vae=f"{OUT_ROOT}/s1_gimo/checkpoints/latest"))


def vae_interactee() -> Preset:
    """Stage 1 with the interactee as the estimated actor
    (`config_vae_interactee.yaml`: ESTIMATE interactee :5)."""
    p = vae_egobody()
    return dataclasses.replace(p, name="s1_interactee",
                               model=dataclasses.replace(p.model, estimate="interactee"))


def mld_interactee() -> Preset:
    """Stage 2 on the interactee token alone (`config_mld_interactee.yaml`:
    condition ['interactee'] :62), over the EgoBody stage-1 VAE (:18)."""
    p = mld_egobody()
    return dataclasses.replace(p, name="s2_interactee",
                               model=dataclasses.replace(p.model, condition=("interactee",)))


PRESETS = {"vae_egobody": vae_egobody, "mld_egobody": mld_egobody,
           "mld_egobody_image": mld_egobody_image, "vae_gimo": vae_gimo, "mld_gimo": mld_gimo,
           "vae_interactee": vae_interactee, "mld_interactee": mld_interactee}

SECTIONS = ("model", "train", "test")


def _literal(raw: str):
    try:
        v = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw
    return tuple(v) if isinstance(v, list) else v


def apply_overrides(preset: Preset, pairs: Sequence[str]) -> Preset:
    """`model.X=V`, `train.X=V` or `test.X=V` pairs (V a Python literal)
    over the preset's fields, as `train.py`'s dotted overrides, and
    `dataset=NAME` (DATASET_NAME: `kit` on a HumanML3D preset)."""
    for pair in pairs:
        path, sep, raw = pair.partition("=")
        if path == "dataset" and raw:
            preset = dataclasses.replace(preset, dataset=raw)
            continue
        section, _, name = path.partition(".")
        if not sep or section not in SECTIONS or not name:
            raise ValueError(f"override {pair!r} is not model.FIELD=VALUE, train.FIELD=VALUE, "
                             "test.FIELD=VALUE or dataset=NAME")
        sub = dataclasses.replace(getattr(preset, section), **{name: _literal(raw)})
        preset = dataclasses.replace(preset, **{section: sub})
    return preset
