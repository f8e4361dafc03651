"""The train and test CLIs under data parallelism, on the CPU: two gloo
ranks in spawned processes (`torch_parallel_worker.py`, which joins the
process group the CLIs then find) against one process, at the tiny size of
the shipped YAMLs with DEBUG's small splits (32 / 16 / 16).
"""

import json
import os

import numpy as np
import pytest
import torch

from seeme_tpu_torch.test.__main__ import main as eval_main
from seeme_tpu_torch.train.__main__ import Trainer, parse_args
from seeme_tpu_torch.train.__main__ import main as train_main
from seeme_tpu_torch.train.loop import run_epoch
from torch_parallel_worker import eval_cli, run_world, train_cli
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE = os.path.join(ROOT, "configs", "config_vae_egobody.yaml")
MLD = os.path.join(ROOT, "configs", "config_mld_egobody.yaml")
YAMLS = sorted(f for f in os.listdir(os.path.join(ROOT, "configs")) if f.startswith("config_"))
TINY = ["DEBUG=true", "model.latent_dim=[1,32]", "model.ff_size=16", "model.num_layers=3",
        "model.scene_points=64", "model.scene_feat_dim=32", "LOGGER.VAL_EVERY_STEPS=1"]


def test_train_cli_two_ranks_match_one_process(tmp_path):
    """Stage 2 (cached scene features, dropout 0) for 2 epochs at batch 8:
    every step's loss and each validation within 1e-4 of one process's (the
    bound of the five-step test), bitwise alike on both ranks, parameters
    bitwise equal across the ranks and close to one process's; rank 0 alone
    wrote the run's files, one checkpoint as one process does."""
    args = ["--cfg", MLD, "--device", "cpu", "--batch_size", "8", "--epochs", "2",
            "TRAIN.FEATURE_CACHE=true", "model.droupout=0.0", *TINY]
    run_world(train_cli, 2, str(tmp_path / "ranks"), [[*args, "--out", str(tmp_path / "two")]])
    one = train_main([*args, "--out", str(tmp_path / "one")])
    r0, r1 = (np.load(tmp_path / "ranks" / f"rank{r}_0.npz") for r in range(2))
    want = [s["total"] for r in one.history for s in r["steps"]]
    assert len(want) == 8
    np.testing.assert_allclose(r0["steps"], want, rtol=1e-4)
    np.testing.assert_allclose(r0["val"], [r["val"]["total"] for r in one.history], rtol=1e-4)
    np.testing.assert_array_equal(r0["steps"], r1["steps"])
    np.testing.assert_array_equal(r0["val"], r1["val"])
    for k in r0.files:
        if k.startswith("p_"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    sd = one.system.state_dict()
    for name in ("denoiser.time_embedding.linear_1.weight", "output_scene.1.weight"):
        np.testing.assert_allclose(r0[f"p_{name}"], sd[name].numpy(), rtol=0, atol=1e-5)
    assert sorted(os.listdir(tmp_path / "two" / "checkpoints")) == \
        sorted(os.listdir(tmp_path / "one" / "checkpoints")) == ["8.pt"]
    assert list(r0["checkpoints"]) == list(r1["checkpoints"]) == \
        [str(tmp_path / "two" / "checkpoints" / "8.pt")]
    logs = [f for f in os.listdir(tmp_path / "two") if f.endswith("_train.log")]
    assert len(logs) == 1
    text = open(tmp_path / "two" / logs[0]).read()
    assert "world=2 backend=gloo" in text and text.count("epoch 1/2") == 1
    assert {"config.json", "config.yaml", "train_log.txt"} <= set(os.listdir(tmp_path / "two"))


def test_train_cli_two_ranks_resume_bitwise(tmp_path):
    """Stage 1 with dropout on at 2 ranks: 2 epochs straight against 1
    epoch, a checkpoint and a resume for the second, bitwise (weights,
    optimizer state, each rank's parameters); the checkpoint holds both
    ranks' default generators, which differ; a resume at world size 1
    raises, naming both sizes."""
    base = ["--cfg", VAE, "--device", "cpu", "--batch_size", "8", *TINY]
    straight, cut = str(tmp_path / "straight"), str(tmp_path / "cut")
    runs = [[*base, "--epochs", "2", "--out", straight], [*base, "--epochs", "1", "--out", cut],
            [*base, "--epochs", "2", "--out", cut, "--resume", cut]]
    run_world(train_cli, 2, str(tmp_path / "ranks"), runs)
    a = torch.load(os.path.join(straight, "checkpoints", "8.pt"), weights_only=False)
    b = torch.load(os.path.join(cut, "checkpoints", "8.pt"), weights_only=False)
    assert a["world"] == b["world"] == 2 and a["step"] == b["step"] == 8
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    for i, state in a["optimizer"]["state"].items():
        for k, v in state.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    ranks = a["rng"]["ranks"]
    assert len(ranks) == 2 and not torch.equal(ranks[0]["cpu"], ranks[1]["cpu"])
    for r in range(2):
        got, want = (np.load(tmp_path / "ranks" / f"rank{r}_{i}.npz") for i in (2, 0))
        np.testing.assert_array_equal(got["steps"], want["steps"][4:])
        for k in want.files:
            if k.startswith("p_"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="world size 2; this run has world size 1"):
        train_main([*base, "--epochs", "3", "--out", cut, "--resume", cut])


@pytest.mark.parametrize("cfg", [MLD, VAE], ids=["sample", "reconstruct"])
def test_ego_test_cli_two_ranks_match_one_process(cfg, tmp_path):
    """The ego test CLI at 2 ranks, batch 12 over the 16-sample split (the
    padded second batch leaves rank 1 no valid row), 2 replications: every
    metric within 1e-6 relative of one process's, alike on both ranks; rank
    0 wrote one metrics file and every sequence's predictions, as one
    process does."""
    args = ["--cfg", cfg, "--device", "cpu", "--batch_size", "12", "--replication_times", "2",
            "--save_predictions", "TEST.SPLIT=val", *TINY]
    run_world(eval_cli, 2, str(tmp_path / "ranks"), [*args, "--out", str(tmp_path / "two")])
    one = eval_main([*args, "--out", str(tmp_path / "one")])
    r0, r1 = (json.load(open(tmp_path / "ranks" / f"rank{r}.json")) for r in range(2))
    assert r0 == r1
    assert len(r0["replications"]) == 2
    for got, want in zip(r0["replications"], one["replications"]):
        assert set(got) == set(want) == {"MPJPE", "ROOT_ERROR", "HEAD_ORIENTATION_ERROR", "ACCL"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    two_files = os.listdir(tmp_path / "two")
    assert len([f for f in two_files if f.startswith("metrics_")]) == 1
    preds = sorted(os.listdir(tmp_path / "two" / "predictions"))
    assert preds == sorted(os.listdir(tmp_path / "one" / "predictions"))
    assert len(preds) == 32
    for f in preds:
        np.testing.assert_allclose(np.load(tmp_path / "two" / "predictions" / f),
                                   np.load(tmp_path / "one" / "predictions" / f),
                                   rtol=0, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("cli", [train_main, eval_main], ids=["train", "test"])
def test_cfg_model_axis_above_one_is_refused_by_name(cli, tmp_path):
    """`--cfg ... MESH.MODEL_AXIS=2` in one process: the train CLI fails
    naming the key before any run starts (one rank does not make a
    (data, model) mesh with a model axis of 2, as `train.py`'s `make_mesh`
    asserts); the test CLI reads no such key, as `test.py` does not, and
    runs."""
    if cli is train_main:
        with pytest.raises(ValueError, match="MESH.MODEL_AXIS=2"):
            cli(["--cfg", MLD, "--device", "cpu", "MESH.MODEL_AXIS=2", "--out", str(tmp_path)])
        assert not os.listdir(tmp_path)
    else:
        result = cli(["--cfg", MLD, "--device", "cpu", "--batch_size", "8", "MESH.MODEL_AXIS=2",
                      "TEST.SPLIT=val", *TINY, "--out", str(tmp_path)])
        assert len(result["replications"]) == 1


@pytest.mark.parametrize("yaml_name,cache", [(y, False) for y in YAMLS]
                         + [("config_mld_egobody.yaml", True)])
def test_every_trained_parameter_gets_a_gradient(yaml_name, cache, tmp_path):
    """DDP does not search each step's graph for unused parameters
    (`parallel/mesh.py::replicated`), which holds only while every
    parameter the stage trains gets a gradient from each step. One step of
    each shipped YAML's route in the train CLI (its stage, the tiny size;
    stage 2 of the ego config also from cached scene features): every
    parameter of the optimizer has a gradient."""
    import itertools

    trainer = Trainer(parse_args(["--cfg", os.path.join(ROOT, "configs", yaml_name), "--device",
                                  "cpu", "--batch_size", "8", "--epochs", "1",
                                  f"TRAIN.FEATURE_CACHE={str(cache).lower()}", *TINY,
                                  "--out", str(tmp_path)]))
    assert (trainer.fill_feature_cache() is not None) == cache
    run_epoch(trainer.system, trainer.stage, trainer.optimizer, trainer.schedule, 0,
              itertools.islice(trainer.train_batches(0), 1), trainer.generator)
    trainer.close()
    names = {id(p): n for n, p in trainer.system.named_parameters()}
    params = [p for group in trainer.optimizer.param_groups for p in group["params"]]
    assert params
    assert [names[id(p)] for p in params if p.grad is None] == []
