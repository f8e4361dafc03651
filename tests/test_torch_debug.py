"""The config's DEBUG on the port's `--cfg` route against the JAX package:
the split sizes of every datamodule, DEBUG true and false, equal
`seeme_tpu.data.get_datamodule(cfg)`'s. The ego and GIMO synthetic sets,
the HumanML3D and HumanAct12 / UESTC synthetic sets go through the port's
whole route (YAML -> `preset_from_yaml` -> `presets.build`); the EgoBody,
HumanAct12 and UESTC releases are written here and read through
`get_datamodule(root=...)` on both sides. The train CLI's `--nodebug`
turns DEBUG off. Sizes are counts, so the check is exact.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from seeme_tpu.config import load_config as j_load_config
from seeme_tpu.config.loader import Config
from seeme_tpu.data import get_datamodule as j_get_datamodule
from seeme_tpu_torch.config import presets
from seeme_tpu_torch.data.registry import get_datamodule
from seeme_tpu_torch.train.__main__ import Trainer, parse_args
from torch_train_common import write_release
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

SPLITS = ("train", "val", "test")
# small widths: the split sizes do not depend on them
SHRINK = ["model.scene_points=64", "model.ff_size=16", "model.num_layers=3",
          "model.scene_feat_dim=32"]


def write_humanact12(path, n=40):
    rng = np.random.RandomState(0)
    lengths = rng.randint(2, 80, n)
    clips = {"poses": [rng.randn(T, 72).astype(np.float32) * 0.3 for T in lengths],
             "joints3D": [rng.randn(T, 24, 3).astype(np.float32) for T in lengths],
             "y": [i % 12 for i in range(n)]}
    with open(path, "wb") as f:
        pickle.dump(clips, f)


def write_uestc(root, n=40):
    """`n` clips of 60 frames on side 1 for each of a training subject (1)
    and a test subject (3)."""
    rng = np.random.RandomState(1)
    names = [f"a{i % 40}_d1_p{p:03d}_c1_color.avi" for p in (1, 3) for i in range(n)]
    (root / "info").mkdir(parents=True)
    (root / "info" / "names.txt").write_text("\n".join(names) + "\n")
    (root / "info" / "num_frames_min.txt").write_text("\n".join("60" for _ in names))
    (root / "info" / "action_classes.txt").write_text("\n".join(f"c{i}" for i in range(40)))
    cam = np.ones((60, 4), np.float32)
    vibe = {"pose": [rng.randn(60, 72).astype(np.float32) * 0.2 for _ in names],
            "joints3d": [rng.randn(60, 49, 3).astype(np.float32) for _ in names],
            "orig_cam": [cam for _ in names]}
    with open(root / "vibe_cache_refined.pkl", "wb") as f:
        pickle.dump(vibe, f)


def sizes(dm, splits=SPLITS):
    return {s: sum(len(ix) for ix in dm.batch_indices(s, 1, shuffle=False, drop_last=False))
            for s in splits}


@pytest.mark.parametrize("yaml_name", ["config_mld_egobody.yaml", "config_vae_gimo.yaml",
                                       "config_mld_humanml3d.yaml", "config_vae_humanact12.yaml",
                                       "config_mld_uestc.yaml"])
@pytest.mark.parametrize("debug", [True, False])
def test_cfg_route_split_sizes_match_jax(yaml_name, debug):
    path = os.path.join("configs", yaml_name)
    overrides = [f"DEBUG={str(debug).lower()}", *SHRINK]
    preset, _ = presets.cli_config(None, path, overrides=overrides)
    assert preset.debug is debug
    dm, _ = presets.build(preset, torch.device("cpu"))
    jdm = j_get_datamodule(j_load_config(path, overrides={"DEBUG": debug,
                                                          "model": {"scene_points": 64}}))
    assert sizes(dm) == sizes(jdm)
    assert dm.num_train == jdm.num_train
    if "egobody" in yaml_name:
        assert sizes(dm) == ({"train": 32, "val": 16, "test": 16} if debug else
                             {"train": 256, "val": 64, "test": 64})


@pytest.mark.parametrize("debug", [True, False])
def test_release_split_sizes_match_jax(tmp_path, debug):
    """EgoBody shards of 12 rows (10 under DEBUG), a HumanAct12 release of
    40 clips and a UESTC one (32 a split under DEBUG; its val is its test)."""
    write_release(tmp_path, n=12)
    act = tmp_path / "HumanAct12Poses"
    act.mkdir()
    write_humanact12(act / "humanact12poses.pkl")
    write_uestc(tmp_path / "uestc")
    for name in ("egobody", "humanact12", "uestc"):
        splits = ("train", "val") if name == "egobody" else SPLITS
        ours = get_datamodule(name, root=str(tmp_path), debug=debug)
        assert not ours.is_synthetic
        theirs = j_get_datamodule(Config({"DATASET_NAME": name, "DEBUG": debug,
                                          "DATASET": {"ROOT": str(tmp_path)}}))
        assert sizes(ours, splits) == sizes(theirs, splits), name
        assert ours.num_train == theirs.num_train, name
    assert sizes(get_datamodule("egobody", root=str(tmp_path), debug=debug),
                 ("train",))["train"] == (10 if debug else 12)
    assert get_datamodule("humanact12", root=str(tmp_path), debug=debug).num_train == (
        32 if debug else 40)


def test_nodebug_gives_the_full_splits(tmp_path):
    """`--cfg ... DEBUG=true` trains on 32 / 16 / 16 and `--nodebug` on
    256 / 64 / 64, as the root `train.py --nodebug`."""
    base = ["--cfg", "configs/config_vae_egobody.yaml", "--device", "cpu", "--epochs", "1"]
    tiny = ["DEBUG=true", "model.latent_dim=[1,32]", "model.ff_size=16", "model.num_layers=3"]
    debug = Trainer(parse_args([*base, "--out", str(tmp_path / "a"), *tiny]))
    assert debug.preset.debug and sizes(debug.datamodule) == {"train": 32, "val": 16, "test": 16}
    full = Trainer(parse_args([*base, "--nodebug", "--out", str(tmp_path / "b"), *tiny]))
    assert not full.preset.debug
    assert sizes(full.datamodule) == {"train": 256, "val": 64, "test": 64}
    assert "DEBUG: false" in (tmp_path / "b" / "config.yaml").read_text()
