"""Every preset the CLIs offer, the ego configs (`config/egobody.py`) and
the text-to-motion ones (`config/humanml3d.py`), and `build`, which makes a
preset's datamodule and system."""

from __future__ import annotations

import dataclasses

import torch

from ..core.smpl import synthetic_smpl
from ..data.registry import get_datamodule
from ..models.seeme import SeeMeSystem
from ..models.t2m import T2MConfig, T2MSystem
from .egobody import PRESETS as EGO_PRESETS
from .egobody import Preset
from .humanml3d import T2M_PRESETS

PRESETS = {**EGO_PRESETS, **T2M_PRESETS}


def build(preset: Preset, device: torch.device):
    """(datamodule, system) of a preset, the system seeded with the preset's
    seed, and torch's default generators too (dropout draws from them). A
    text-to-motion system takes its width in features from the data (263
    for HumanML3D, 251 for KIT), as `build_t2m_system` does; an ego system
    gets the synthetic SMPL body."""
    cfg, seed = preset.model, preset.train.seed
    torch.manual_seed(seed)
    if isinstance(cfg, T2MConfig):
        dm = get_datamodule(preset.dataset, motion_length=cfg.max_len, min_len=cfg.min_len,
                            text_dim=cfg.text_encoded_dim)
        cfg = dataclasses.replace(cfg, nfeats=dm.nfeats)
        return dm, T2MSystem(cfg, dm.mean, dm.std, device=device, seed=seed)
    dm = get_datamodule(preset.dataset, cfg.condition, cfg.motion_length, cfg.scene_points,
                        image_size=cfg.image_size)
    return dm, SeeMeSystem(cfg, synthetic_smpl(n_verts=6890), dm.mean, dm.std, device=device,
                           seed=seed)
