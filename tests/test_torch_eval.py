"""The port's evaluation path on the CPU: `EgoMetric`, `interactee_mpjpe`
and `get_metric_statistics` against the JAX package's, and the test CLI
(`python -m seeme_tpu_torch.test`) end to end at a tiny size: the
condition tokens encoded once per batch and reused across replications
(again every batch with `--count_time`), the padded tail left out of the
metric, per-replication seeds, checkpoint loading, the files it writes."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.eval import EgoMetric as JEgoMetric
from seeme_tpu.eval import get_metric_statistics as j_statistics
from seeme_tpu.eval.metrics import interactee_mpjpe as j_interactee_mpjpe
from seeme_tpu_torch.core.rotations import aa_to_quat
from seeme_tpu_torch.eval.metrics import EgoMetric, interactee_mpjpe
from seeme_tpu_torch.eval.stats import get_metric_statistics
from seeme_tpu_torch.models.seeme import SeeMeSystem
from seeme_tpu_torch.test.__main__ import Evaluator, main, parse_args
from seeme_tpu_torch.train.checkpoint import save_state
from seeme_tpu_torch.train.state import make_optimizer
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

TINY = ["model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
        "model.scene_points=64", "model.scene_feat_dim=32", "model.image_size=32",
        "model.num_inference_timesteps=5"]


def metric_inputs(seed, B=6, T=20):
    rng = np.random.RandomState(seed)
    jts = rng.randn(4, B, T, 24, 3).astype(np.float32) * 0.1
    jts[1] += jts[0]  # ground truth near the prediction, so some sequences pass the filter
    quat = rng.randn(2, B, T, 3).astype(np.float32) * 0.3
    quat[1] = quat[0] + 0.05 * rng.randn(B, T, 3)
    mask = np.arange(T)[None] < rng.randint(T // 2, T + 1, B)[:, None]
    quats = [np.asarray(aa_to_quat(torch.as_tensor(q))) for q in quat]
    return jts, quats, mask


@pytest.mark.parametrize("split", ["test", "val"])
def test_ego_metric_matches_jax(split):
    """Two batches accumulated with the interactee joints: the same keys,
    counts and means (the test split's filter keeps some sequences and drops
    others)."""
    ours, theirs = EgoMetric(split=split), JEgoMetric(split=split)
    for seed in (0, 1):
        jts, quats, mask = metric_inputs(seed)
        args = (jts[0], jts[1], quats[0], quats[1], mask, jts[2], jts[3])
        ours.update(*(torch.as_tensor(a) for a in args))
        theirs.update(*(jnp.asarray(a) for a in args))
    assert ours.counts == theirs.counts
    if split == "test":
        assert 0 < ours.counts["MPJPE"] < ours.counts["mpjpe_interactee"] == 12
    got, ref = ours.compute(), theirs.compute()
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    ours.reset()
    assert ours.compute() == {}


def test_interactee_mpjpe_matches_jax():
    jts, _, mask = metric_inputs(2)
    np.testing.assert_allclose(
        interactee_mpjpe(torch.as_tensor(jts[2]), torch.as_tensor(jts[3]), torch.as_tensor(mask)),
        np.asarray(j_interactee_mpjpe(jnp.asarray(jts[2]), jnp.asarray(jts[3]), jnp.asarray(mask))),
        rtol=1e-5)


def test_metric_statistics_match_jax():
    reps = [{"MPJPE": 100.0 + i, "ACCL": 3.0 * i} for i in range(4)] + [{"MPJPE": 97.5}]
    assert get_metric_statistics(reps) == j_statistics(reps)
    assert get_metric_statistics(reps[:1])["MPJPE"]["conf_interval"] == 0.0


def counting(monkeypatch, cls, name):
    calls = []
    real = getattr(cls, name)

    def wrapper(self, *a, **k):
        calls.append(a[0])
        return real(self, *a, **k)

    monkeypatch.setattr(cls, name, wrapper)
    return calls


def test_cli_evaluates_the_image_config_on_the_cpu(tmp_path, monkeypatch):
    """`mld_egobody_image` over the 64-sample synthetic test split in batches
    of 24 (the last padded), 2 replications: 3 condition encodes, 6
    samplings; every metric call sees 64 rows; the replications differ
    (seeds 1234 and 1235) and a rerun repeats them; the metrics JSON holds
    finite mean / CI / min / max of the four metrics."""
    encodes = counting(monkeypatch, SeeMeSystem, "encode_conditioning")
    samples = counting(monkeypatch, SeeMeSystem, "sample_from_cond")
    rows = counting(monkeypatch, EgoMetric, "update")
    argv = ["--preset", "mld_egobody_image", "--device", "cpu", "--batch_size", "24",
            "--replication_times", "2", "test.split='val'", *TINY]
    result = main([*argv, "--out", str(tmp_path / "a")])
    assert (len(encodes), len(samples)) == (3, 6)
    assert [r.shape[0] for r in rows] == [24, 24, 16] * 2
    reps = result["replications"]
    assert set(reps[0]) == {"MPJPE", "ROOT_ERROR", "HEAD_ORIENTATION_ERROR", "ACCL"}
    assert reps[0]["MPJPE"] != reps[1]["MPJPE"]
    with open(result["metrics_path"]) as f:
        stats = json.load(f)
    assert set(stats) == set(reps[0])
    for s in stats.values():
        assert set(s) == {"mean", "conf_interval", "min", "max"}
        assert all(np.isfinite(v) for v in s.values())
    again = main([*argv, "--out", str(tmp_path / "b")])
    assert again["replications"] == reps
    assert os.path.exists(tmp_path / "a" / "test_log.txt")


def test_cli_count_time_checkpoint_and_predictions(tmp_path, monkeypatch):
    """With `--count_time` every batch encodes again and `times.txt` holds
    one line a batch; `--save_predictions` writes each sequence's joints
    once; a trainer checkpoint loads; a named checkpoint that is missing is
    refused; the stage-1 route reconstructs (GIMO, 69 features)."""
    ev = Evaluator(parse_args(["--preset", "mld_interactee", "--device", "cpu", *TINY]
                              + ["--out", str(tmp_path / "ckpt")]))
    with torch.no_grad():
        for p in ev.system.parameters():
            p.add_(0.01)
    optimizer, _ = make_optimizer("diffusion", ev.system)
    path = save_state(str(tmp_path / "ckpt"), ev.system, optimizer, 3, 1)

    encodes = counting(monkeypatch, SeeMeSystem, "encode_conditioning")
    out = tmp_path / "timed"
    result = main(["--preset", "mld_interactee", "--device", "cpu", "--batch_size", "32",
                   "--replication_times", "2", "--count_time", "--save_predictions",
                   "--checkpoint", path, "--out", str(out), *TINY])
    assert len(encodes) == 4 and len(result["times"]) == 4
    assert len(open(out / "times.txt").read().split()) == 4
    assert sorted(os.listdir(out / "predictions"))[:2] == ["gt_0.npy", "gt_1.npy"]
    assert len(os.listdir(out / "predictions")) == 2 * 64
    assert np.load(out / "predictions" / "pred_63.npy").shape == (60, 24, 3)
    assert "loaded checkpoint" in open(out / "test_log.txt").read()
    with pytest.raises(FileNotFoundError, match="does not exist"):
        main(["--preset", "mld_interactee", "--device", "cpu", "--checkpoint",
              str(tmp_path / "absent.pt"), "--out", str(out), *TINY])

    recon = counting(monkeypatch, SeeMeSystem, "reconstruct")
    result = main(["--preset", "vae_gimo", "--device", "cpu", "--out", str(tmp_path / "vae"),
                   "test.mean=True", *TINY])
    assert len(recon) == 1 and recon[0]["feats"].shape[-1] == 66
    assert all(np.isfinite(v) for s in result["stats"].values() for v in s.values())


def test_cli_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--preset", "mld_egobody", "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="FIELD=VALUE"):
        main(["--preset", "mld_egobody", "--device", "cpu", "--out", str(tmp_path), "x=1"])
