"""Every preset the CLIs offer, the ego configs (`config/egobody.py`), the
text-to-motion ones (`config/humanml3d.py`) and the action-to-motion ones
(`config/a2m.py`); `cli_config` / `from_cli`, which give the preset a CLI
names by `--preset` or by `--cfg` (a shipped YAML through `config/loader.py`
and `config/build.py`); and `build`, which makes a preset's datamodule and
system. Each preset is the config its YAML builds
(`tests/test_torch_config.py`)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..core.smpl import smpl_body
from ..data.registry import get_datamodule
from ..models.a2m import A2MConfig, A2MSystem
from ..models.seeme import SeeMeSystem
from ..models.t2m import T2MConfig, T2MSystem
from .a2m import A2M_PRESETS
from .egobody import PRESETS as EGO_PRESETS
from .egobody import Preset, apply_overrides
from .humanml3d import T2M_PRESETS
from .loader import Config

PRESETS = {**EGO_PRESETS, **T2M_PRESETS, **A2M_PRESETS}


def cli_config(preset: Optional[str], cfg: Optional[str], cfg_assets: Optional[str] = None,
               overrides: Sequence[str] = ()) -> Tuple[Preset, Optional[Config]]:
    """(the preset a CLI names, the loaded YAML config with `--cfg`, else
    None): `--preset NAME` with `model.X=V`, `train.X=V`, `test.X=V`
    overrides (Python literals, `apply_overrides`), or `--cfg FILE
    [--cfg_assets FILE]` with dotted YAML overrides (`TRAIN.BATCH_SIZE=8
    model.latent_dim=[2,256]`), as `train.py` and `test.py` read them."""
    if (preset is None) == (cfg is None):
        raise ValueError("name the config by --preset or by --cfg, not both or neither")
    if cfg is None:
        return apply_overrides(PRESETS[preset](), overrides), None
    from .build import preset_from_yaml
    from .loader import load_config, parse_dotted_overrides

    loaded = load_config(cfg, cfg_assets, overrides=parse_dotted_overrides(overrides))
    return preset_from_yaml(loaded), loaded


def from_cli(preset: Optional[str], cfg: Optional[str], cfg_assets: Optional[str] = None,
             overrides: Sequence[str] = ()) -> Preset:
    """The preset of `cli_config`."""
    return cli_config(preset, cfg, cfg_assets, overrides)[0]


def build(preset: Preset, device: torch.device):
    """(datamodule, system) of a preset, the system seeded with the preset's
    seed, and torch's default generators too (dropout draws from them). A
    text-to-motion system takes its width in features from the data (263
    for HumanML3D, 251 for KIT), as `build_t2m_system` does; an
    action-to-motion system its classes and width (`build_a2m_system`); an
    ego or action-to-motion system gets the SMPL body of `preset.smpl_path`
    (the `--cfg` route's `model.smpl_path`, as `seeme_tpu/config/build.py:157`
    and `test.py:387` read it), the synthetic one when that is empty. Every
    datamodule gets the preset's DEBUG, as `seeme_tpu/data/registry.py`
    reads the config's."""
    cfg, seed = preset.model, preset.train.seed
    torch.manual_seed(seed)
    if isinstance(cfg, T2MConfig):
        dm = get_datamodule(preset.dataset, motion_length=cfg.max_len, min_len=cfg.min_len,
                            text_dim=cfg.text_encoded_dim, debug=preset.debug)
        cfg = dataclasses.replace(cfg, nfeats=dm.nfeats)
        return dm, T2MSystem(cfg, dm.mean, dm.std, device=device, seed=seed)
    if isinstance(cfg, A2MConfig):
        dm = get_datamodule(preset.dataset, motion_length=cfg.num_frames, debug=preset.debug)
        cfg = dataclasses.replace(cfg, nfeats=dm.nfeats, num_classes=dm.num_classes)
        return dm, A2MSystem(cfg, smpl_body(preset.smpl_path), device=device, seed=seed)
    dm = get_datamodule(preset.dataset, cfg.condition, cfg.motion_length, cfg.scene_points,
                        image_size=cfg.image_size, debug=preset.debug)
    return dm, SeeMeSystem(cfg, smpl_body(preset.smpl_path), dm.mean, dm.std, device=device,
                           seed=seed)
