"""The port's train CLI on the CPU, both stages, and its refusal without a
card (helpers in `torch_train_common.py`).
"""

import os

import numpy as np
import pytest
import torch

from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.models.seeme import SeeMeSystem
from seeme_tpu_torch.train.__main__ import main
from torch_train_common import (
    TINY,
)
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)


def test_cli_trains_both_stages_on_the_cpu(tmp_path):
    """`main(argv)` for one epoch of each stage at a tiny size: stage 1
    writes a checkpoint; stage 2 loads its VAE, fills the scene-feature
    cache, trains the denoiser and `output_scene` with the VAE and PointNet
    unchanged, validates and checkpoints."""
    s1 = main(["--preset", "vae_egobody", "--device", "cpu", "--batch_size", "32", "--epochs", "1",
               "--out", str(tmp_path / "s1"), *TINY])
    assert s1.step == 8 and s1.checkpoints == [str(tmp_path / "s1" / "checkpoints" / "8.pt")]
    assert all(np.isfinite(s["total"]) for s in s1.history[0]["steps"])
    assert set(s1.history[0]["val"]) == {"total", "recons_feature", "recons_joints",
                                          "recons_transl", "kl_motion"}
    s2 = main(["--preset", "mld_egobody", "--device", "cpu", "--batch_size", "32", "--epochs", "1",
               "--out", str(tmp_path / "s2"), "--pretrained_vae",
               str(tmp_path / "s1" / "checkpoints" / "latest"), "train.feature_cache=True", *TINY])
    assert s2.datamodule.train_set.extras["scene_feats"].shape == (256, 32)
    assert s2.datamodule.val_set.extras["scene_feats"].shape == (64, 32)
    vae = s1.system.vae.state_dict()
    for k, v in s2.system.vae.state_dict().items():
        assert torch.equal(v, vae[k]), k
    fresh = SeeMeSystem(s2.preset.model, synthetic_smpl(32), np.zeros(75), np.ones(75),
                        device="cpu", seed=s2.seed)
    for k, v in fresh.proscene.state_dict().items():
        assert torch.equal(v, s2.system.proscene.state_dict()[k]), k
    assert not torch.equal(fresh.output_scene[1].weight, s2.system.output_scene[1].weight)
    assert s2.step == 8 and np.isfinite(s2.history[0]["val"]["total"])
    assert os.path.exists(tmp_path / "s2" / "checkpoints" / "8.pt")
    assert os.path.exists(tmp_path / "s2" / "config.json")


def test_cli_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--preset", "vae_egobody", "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="FIELD=VALUE"):
        main(["--preset", "vae_egobody", "--device", "cpu", "--out", str(tmp_path), "lr=1"])
