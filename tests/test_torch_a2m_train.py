"""The action-to-motion presets against the shipped YAML files (through the
JAX package's `load_config` and `build_a2m_system`), and both stages of the
train CLI on the CPU at a tiny size (latent 1 x 32, 3 layers, 16 frames):
stage 1 trains and checkpoints the VAE; stage 2 loads it, keeps it bitwise,
trains the denoiser and the action table, validates and checkpoints.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from seeme_tpu.config import load_config
from seeme_tpu.config.build import build_a2m_system
from seeme_tpu.data import get_datamodule as j_get_datamodule
from seeme_tpu.models.a2m import A2MConfig as JConfig
from seeme_tpu_torch.config.a2m import A2M_PRESETS
from seeme_tpu_torch.config.presets import PRESETS
from seeme_tpu_torch.models.a2m import A2MSystem
from seeme_tpu_torch.train.__main__ import main
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

JAX_FIELDS = {f.name for f in dataclasses.fields(JConfig)}


@pytest.mark.parametrize("preset", sorted(A2M_PRESETS))
def test_presets_match_the_yaml(preset):
    """Each model field equals what `build_a2m_system` makes of the YAML
    (classes from the datamodule), and the train and test settings too."""
    root = os.path.join(os.path.dirname(__file__), "..", "configs")
    cfg = load_config(os.path.join(root, f"config_{preset}.yaml"))
    _, ref = build_a2m_system(cfg, j_get_datamodule(cfg))
    p = PRESETS[preset]()
    assert PRESETS[preset] is A2M_PRESETS[preset]
    model = dataclasses.replace(p.model, num_classes=40 if "uestc" in preset else 12)
    assert {f.name for f in dataclasses.fields(model)} == JAX_FIELDS
    for name in JAX_FIELDS:
        assert getattr(model, name) == getattr(ref, name), name
    t = p.train
    assert (t.stage, t.batch_size, t.end_epoch) == (cfg.TRAIN.STAGE, cfg.TRAIN.BATCH_SIZE,
                                                    cfg.TRAIN.END_EPOCH)
    assert (t.lr, t.step_size, t.gamma) == (float(cfg.TRAIN.OPTIM.LR), cfg.TRAIN.OPTIM.STEP_SIZE,
                                            cfg.TRAIN.OPTIM.GAMMA)
    assert (t.val_every_steps, t.save_checkpoint_epoch) == (cfg.LOGGER.VAL_EVERY_STEPS,
                                                            cfg.LOGGER.SACE_CHECKPOINT_EPOCH)
    assert (t.seed, p.name, p.dataset) == (cfg.SEED_VALUE, cfg.NAME, cfg.DATASET_NAME)
    if cfg.TRAIN.PRETRAINED_VAE:
        assert t.pretrained_vae.split("/")[-3] == cfg.TRAIN.PRETRAINED_VAE.split("/")[-3]
    else:
        assert t.pretrained_vae == ""
    assert (p.test.batch_size, p.test.replication_times) == (cfg.TEST.BATCH_SIZE,
                                                             cfg.TEST.REPLICATION_TIMES)


TINY = ["model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
        "model.num_frames=16", "train.val_every_steps=1"]


@pytest.mark.parametrize("dataset", ["humanact12", "uestc"])
def test_cli_trains_both_stages_on_the_cpu(dataset, tmp_path):
    """`main(argv)`: 240 synthetic samples at batch 64 are 3 steps an epoch;
    stage 2 starts from stage 1's VAE and leaves it bitwise as loaded."""
    common = ["--device", "cpu", "--batch_size", "64", "--epochs", "1", *TINY]
    s1 = main(["--preset", f"vae_{dataset}", "--out", str(tmp_path / "s1"), *common])
    assert isinstance(s1.system, A2MSystem) and s1.system.cfg.num_classes == (
        40 if dataset == "uestc" else 12)
    assert s1.step == 3 and s1.checkpoints == [str(tmp_path / "s1" / "checkpoints" / "3.pt")]
    assert set(s1.history[0]["val"]) == {"total", "recons_feature", "kl_motion"}
    assert all(np.isfinite(s["total"]) for s in s1.history[0]["steps"])
    s2 = main(["--preset", f"mld_{dataset}", "--out", str(tmp_path / "s2"),
               "--pretrained_vae", str(tmp_path / "s1" / "checkpoints" / "latest"), *common])
    for k, v in s2.system.vae.state_dict().items():
        assert torch.equal(v, s1.system.vae.state_dict()[k]), k
    fresh = A2MSystem(s2.system.cfg, device="cpu", seed=s2.seed)
    for name in ("denoiser", "embed_action"):
        theirs = getattr(fresh, name).state_dict()
        assert any(not torch.equal(v, theirs[k])
                   for k, v in getattr(s2.system, name).state_dict().items()), name
    assert set(s2.history[0]["val"]) == {"total", "inst_loss"} and s2.step == 3
    assert all(np.isfinite(s["total"]) for s in s2.history[0]["steps"])
    assert os.path.exists(tmp_path / "s2" / "checkpoints" / "3.pt")


def test_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--preset", "mld_humanact12", "--out", str(tmp_path)])
