"""The text-to-motion train CLI, the VAE at its own widths and the data of the
port against the JAX package (helpers in `torch_t2m_train_common.py`; see
`test_torch_t2m_train.py`).
"""

import jax
import numpy as np
import pytest
import torch

from seeme_tpu.config.loader import Config
from seeme_tpu.data.humanml import HumanML3DDataModule as JDataModule
from seeme_tpu_torch.data.humanml import HumanML3DDataModule
from seeme_tpu_torch.data.registry import get_datamodule
from seeme_tpu_torch.train.__main__ import main
from torch_t2m_train_common import (
    batch,
    build,
    close,
    jdm,
    MODULE_RTOL,
    same_batches,
    T,
    TEXT,
    TINY,
    write_release,
)
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)


def test_vae_at_its_own_widths_matches_flax(jdm):
    """`vae_num_layers` / `vae_ff_size` apart from the denoiser's (5 x 24 vs
    3 x 16), and `mlp_dist`: encode and decode as the flax VAE."""
    system, jsystem, params = build(jdm, vae_num_layers=5, vae_ff_size=24, mlp_dist=True)
    assert len(system.vae.encoder.input_blocks) == 2 and len(system.denoiser.encoder.input_blocks) == 1
    assert system.vae.encoder.middle_block.linear1.out_features == 24
    tb, jb = batch(jdm)
    mu, logvar = system.vae.encode(tb["motion"], tb["length"])
    jmu, jlogvar = jax.jit(lambda p, m, n: jsystem.vae.apply(p, m, n, method=jsystem.vae.encode))(
        params["vae"], jb["motion"], jb["length"])
    close(mu.detach().numpy(), jmu, MODULE_RTOL)
    close(logvar.detach().numpy(), jlogvar, MODULE_RTOL)
    out = system.vae.decode(mu, T, tb["length"])
    jout = jax.jit(lambda p, z, n: jsystem.vae.apply(p, z, T, n, method=jsystem.vae.decode))(
        params["vae"], jmu, jb["length"])
    close(out.detach().numpy(), jout, MODULE_RTOL)


def test_cli_trains_both_stages_and_novae_on_the_cpu(tmp_path):
    """`main(argv)` at a tiny size: stage 1 checkpoints; stage 2 loads that
    VAE, keeps it bitwise, trains the denoiser and validates; a resume
    continues at the saved step; novae trains its diffusion stage and
    refuses a VAE stage; `dataset=kit` takes 251 features."""
    common = ["--device", "cpu", "--batch_size", "64", "--epochs", "1", *TINY]
    s1 = main(["--preset", "vae_humanml3d", "--out", str(tmp_path / "s1"), *common])
    assert s1.step == 4 and s1.checkpoints == [str(tmp_path / "s1" / "checkpoints" / "4.pt")]
    assert set(s1.history[0]["val"]) == {"total", "recons_feature", "recons_joints", "kl_motion"}
    assert all(np.isfinite(s["total"]) for s in s1.history[0]["steps"])
    s2 = main(["--preset", "mld_humanml3d", "--out", str(tmp_path / "s2"),
               "--pretrained_vae", str(tmp_path / "s1" / "checkpoints" / "latest"), *common])
    for k, v in s2.system.vae.state_dict().items():
        assert torch.equal(v, s1.system.vae.state_dict()[k]), k
    assert set(s2.history[0]["val"]) == {"total", "inst_loss"} and s2.step == 4
    again = main(["--preset", "mld_humanml3d", "--out", str(tmp_path / "s2"), "--resume",
                  str(tmp_path / "s2"), *common[:-len(TINY) - 2], "--epochs", "2", *TINY])
    assert again.start_epoch == 1 and again.step == 8
    nv = main(["--preset", "novae_humanml3d", "--out", str(tmp_path / "nv"), *common,
               "model.num_layers=2", "model.num_heads=2"])
    assert nv.system.diffusion_only and not hasattr(nv.system, "vae") and nv.step == 4
    with pytest.raises(ValueError, match="vae stage is undefined"):
        main(["--preset", "novae_humanml3d", "--out", str(tmp_path / "nv1"), *common,
              "train.stage='vae'"])
    kit = main(["--preset", "vae_humanml3d", "--out", str(tmp_path / "kit"), *common,
                "dataset=kit"])
    assert kit.system.cfg.nfeats == 251 and kit.datamodule.njoints == 21


def test_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--preset", "mld_humanml3d", "--out", str(tmp_path)])


def test_datamodule_matches_jax_on_a_written_release(tmp_path):
    """The release's batches (shuffled order and unit-length crops from
    `random.Random(seed)`, the missing and the too-short clips skipped),
    `renorm4t2m` with the evaluator statistics, `feats2joints`, and
    `get_datamodule` choosing the release, also for KIT's 251 features."""
    root = write_release(tmp_path / "HumanML3D")
    jcfg = Config({"DATASET": {"SAMPLER": {"MAX_LEN": 48, "MIN_LEN": 40}}})
    ours, theirs = HumanML3DDataModule(str(root), max_len=48), JDataModule(jcfg, str(root))
    assert not ours.is_synthetic and ours.num_train == theirs.num_train == 6
    for seed in (0, 3):
        same_batches(ours.batches("train", 2, seed=seed, drop_last=False),
                     theirs.batches("train", 2, seed=seed, drop_last=False))
    same_batches(ours.batches("test", 2, shuffle=False), theirs.batches("test", 2, shuffle=False))
    b = next(ours.batches("test", 2, shuffle=False))
    assert b["text"] == ["a person walks number 000001", "a person walks number M000004"]
    np.testing.assert_allclose(ours.renorm4t2m(b["motion"]), theirs.renorm4t2m(b["motion"]),
                               rtol=1e-6)
    joints = ours.feats2joints(torch.as_tensor(b["motion"]))
    close(joints.numpy(), theirs.feats2joints(b["motion"]), MODULE_RTOL)
    with pytest.raises(KeyError):
        ours.split_arrays("train")
    assert not get_datamodule("humanml3d", root=str(tmp_path), motion_length=48).is_synthetic
    kit_root = write_release(tmp_path / "KIT-ML", nfeats=251)
    kit = get_datamodule("kit", root=str(tmp_path), motion_length=48)
    jkit = JDataModule(jcfg, str(kit_root), nfeats=251)
    assert kit.nfeats == 251 and kit.njoints == 21
    same_batches(kit.batches("train", 2, seed=1), jkit.batches("train", 2, seed=1))
    assert get_datamodule("kit", root=str(tmp_path / "absent")).is_synthetic


def test_synthetic_datamodule_matches_jax():
    """The synthetic splits (256 / 64 / 64) with their captions: batches,
    split arrays and batch order as the JAX module's, `renorm4t2m` the raw
    features."""
    jdm = JDataModule(Config({"DATASET": {"SAMPLER": {"MAX_LEN": T, "MIN_LEN": 8}},
                              "model": {"denoiser": {"params": {"text_encoded_dim": TEXT}}}}))
    ours = HumanML3DDataModule(None, max_len=T, min_len=8, text_dim=TEXT)
    assert ours.is_synthetic and ours.num_train == jdm.num_train == 256
    same_batches(ours.batches("train", 8, seed=4), jdm.batches("train", 8, seed=4))
    same_batches(ours.batches("test", 8, shuffle=False, drop_last=False),
                 jdm.batches("test", 8, shuffle=False, drop_last=False))
    arrays, ref = ours.split_arrays("val"), jdm.split_arrays("val")
    assert set(arrays) == set(ref)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], ref[k])
    for a, b in zip(ours.batch_indices("train", 8, seed=2), jdm.batch_indices("train", 8, seed=2)):
        np.testing.assert_array_equal(a, b)
    m = arrays["motion"][:2]
    np.testing.assert_allclose(ours.renorm4t2m(m), jdm.renorm4t2m(m), rtol=1e-6)
    assert [len(ours._sets[s]) for s in ("train", "val", "test")] == [256, 64, 64]
