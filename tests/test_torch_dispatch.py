"""The train loop's two dispatch routes (`seeme_tpu_torch/train/loop.py`:
`run_epoch(..., steps_per_dispatch=k)` over host batches and
`run_epoch_device` over a split held on the device) against each other,
against single steps, and against the JAX package's
`run_epoch_device(make_gather_scan_train_step(...))`; the train CLI's
choice of route (`TRAIN.DEVICE_DATA`, `TRAIN.STEPS_PER_DISPATCH`,
`TRAIN.DEVICE_DATA_MAX_GB`, as `train.py:246-327`), its log lines, resume
across the routes, and the device route under DDP.

The ports' routes are held to each other bitwise (the same batches, draws
and arithmetic); the JAX comparison feeds the JAX step's own draws to the
port, at the tolerance of the five-step tests (1e-4 relative).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.config.loader import Config
from seeme_tpu.data.humanml import HumanML3DDataModule as JT2MDataModule
from seeme_tpu.data.registry import SyntheticA2MDataModule as JA2MDataModule
from seeme_tpu.train.loop import make_gather_scan_train_step
from seeme_tpu.train.loop import run_epoch_device as j_run_epoch_device
from seeme_tpu.train.state import create_train_state, make_optimizer as j_make_optimizer
from seeme_tpu_torch.config.egobody import TrainConfig
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.humanml import HumanML3DDataModule
from seeme_tpu_torch.data.registry import SyntheticA2MDataModule, SyntheticDataModule
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset
from seeme_tpu_torch.models.a2m import A2MConfig, A2MSystem
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.nn.init import perturb_parameters_
from seeme_tpu_torch.train import loop
from seeme_tpu_torch.train.__main__ import Trainer, dispatch_settings, parse_args
from seeme_tpu_torch.train.__main__ import main as train_main
from seeme_tpu_torch.train.loop import make_device_data, run_epoch, run_epoch_device
from seeme_tpu_torch.train.state import make_optimizer
from torch_parallel_worker import run_world, train_cli
from torch_t2m_train_common import write_release
from torch_train_common import BOTH, JConfig, JSystem, POINTS, SMALL, T, jax_datamodule, \
    jax_draws, jax_params
from seeme_tpu.core.smpl import synthetic_smpl as j_synthetic_smpl
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
MLD = os.path.join(CONFIGS, "config_mld_egobody.yaml")
TINY = ["DEBUG=true", "model.latent_dim=[1,32]", "model.ff_size=16", "model.num_layers=3",
        "model.scene_points=64", "model.scene_feat_dim=32", "LOGGER.VAL_EVERY_STEPS=1"]
OPT = dict(lr=1e-3, step_size_epochs=2, gamma=0.2, steps_per_epoch=7)
A2M_SMALL = dict(latent_dim=(1, 32), ff_size=16, num_layers=3, num_frames=16, dropout=0.0)


def ego(stage, seed=1):
    """A tiny ego system of the stage (dropout 0) and its optimizer."""
    data = SyntheticEgoDataset(14, T, scene_points=POINTS, seed=0)
    condition = () if stage == "vae" else BOTH
    system = SeeMeSystem(SeeMeConfig(condition=condition, **SMALL), synthetic_smpl(256),
                         data.mean, data.std, device="cpu", seed=seed)
    perturb_parameters_(system, torch.Generator().manual_seed(seed + 1))
    return data, system, *make_optimizer(stage, system, **OPT)


def ego_arrays(data, stage):
    arrays = dict(data.split_arrays())
    if stage == "vae":
        arrays.pop("scene")
    return arrays


def ego_batches(data, stage, seed):
    for b in data.batches(2, seed=seed):
        if stage == "vae":
            b.pop("scene")
        yield b


def a2m(stage, seed=1):
    dm = SyntheticA2MDataModule(12, num_frames=16, debug=True)
    system = A2MSystem(A2MConfig(num_classes=12, **A2M_SMALL), synthetic_smpl(256),
                       device="cpu", seed=seed)
    perturb_parameters_(system, torch.Generator().manual_seed(seed + 1))
    return dm, system, *make_optimizer(stage, system, **OPT)


def same_epochs(a, b):
    """Two `run_epoch` results and their systems, bitwise alike."""
    (ra, sa), (rb, sb) = a, b
    assert ra[0] == rb[0] and ra[1] == rb[1] and ra[2] == rb[2]
    assert len(ra[3]) == len(rb[3]) == len(ra[2])
    for k, v in sa.state_dict().items():
        assert torch.equal(v, sb.state_dict()[k]), k


REAL_FETCH = loop.fetch_steps


def counting_fetches(monkeypatch):
    """A list that gets the number of steps of each fetch from now on."""
    calls = []

    def fetch(keys, rows):
        calls.append(len(rows))
        return REAL_FETCH(keys, rows)

    monkeypatch.setattr(loop, "fetch_steps", fetch)
    return calls


@pytest.mark.parametrize("stage", ["vae", "diffusion"])
def test_grouped_host_epoch_matches_single_steps(stage, monkeypatch):
    """`run_epoch` at k = 3 over 7 host batches (two groups and a tail of
    one, as `tests/test_end_to_end.py:213-247`) against k = 1: the same
    update count, step terms, means and parameters, bitwise; 3 fetches
    against 7."""
    runs, fetches = [], []
    for k in (1, 3):
        data, system, opt, sched = ego(stage)
        calls = counting_fetches(monkeypatch)
        result = run_epoch(system, stage, opt, sched, 0, ego_batches(data, stage, 11),
                           torch.Generator().manual_seed(9), steps_per_dispatch=k)
        runs.append((result, system))
        fetches.append(calls)
    same_epochs(*runs)
    assert runs[0][0][0] == 7
    assert fetches == [[1] * 7, [3, 3, 1]]


@pytest.mark.parametrize("case", ["ego-vae", "ego-diffusion", "a2m-vae", "a2m-diffusion"])
def test_device_epoch_matches_host_epoch(case, monkeypatch):
    """`run_epoch_device` at k = 3 over the split held on the device against
    `run_epoch` over the same batches from the host at k = 1, for ego and
    a2m (as `tests/test_end_to_end.py:270-300`, `tests/test_a2m.py:64-108`):
    bitwise alike; one fetch a group."""
    kind, stage = case.split("-")
    runs = []
    for route in ("host", "device"):
        if kind == "ego":
            data, system, opt, sched = ego(stage)
            host = ego_batches(data, stage, 21)
            arrays, index = ego_arrays(data, stage), data.batch_indices(2, seed=21)
        else:
            data, system, opt, sched = a2m(stage)
            host = data.batches("train", 8, seed=21)
            arrays, index = data.split_arrays("train"), data.batch_indices("train", 8, seed=21)
        gen = torch.Generator().manual_seed(9)
        calls = counting_fetches(monkeypatch)
        if route == "host":
            result = run_epoch(system, stage, opt, sched, 0, host, gen)
        else:
            result = run_epoch_device(system, stage, opt, sched, 0,
                                      make_device_data(arrays, "cpu"), index, gen,
                                      steps_per_dispatch=3)
        runs.append((result, system))
    same_epochs(*runs)
    n = runs[0][0][0]
    assert n == (7 if kind == "ego" else 6) and calls == [3] * (n // 3) + [n % 3] * (n % 3 > 0)


def _gather_all(arrays, index):
    data = make_device_data(arrays, "cpu")
    return [{k: v.index_select(0, torch.as_tensor(sel)).numpy() for k, v in data.items()}
            for sel in index]


@pytest.mark.parametrize("kind", ["ego", "t2m", "a2m"])
def test_gathered_batches_equal_jax_take(kind):
    """The device route's batches (`index_select` over `make_device_data`
    of `split_arrays`, along `batch_indices`) equal the JAX `jnp.take` over
    the JAX datamodule's `split_arrays` with its `batch_indices`, bitwise,
    key for key, for two epochs' seeds."""
    if kind == "ego":
        ours, theirs = SyntheticDataModule(BOTH, T, scene_points=16), jax_datamodule(BOTH)
        B = 8
    elif kind == "t2m":
        ours = HumanML3DDataModule(None, max_len=24, min_len=8, text_dim=48, num_train=32)
        theirs = JT2MDataModule(Config({"DEBUG": True, "DATASET": {"SAMPLER": {
            "MAX_LEN": 24, "MIN_LEN": 8}}, "model": {"denoiser": {"params": {
                "text_encoded_dim": 48}}}}))
        B = 8
    else:
        ours, theirs = SyntheticA2MDataModule(12), JA2MDataModule({"DATASET_NAME": "humanact12"})
        B = 16
    for seed in (1234, 1235):
        got = _gather_all(ours.split_arrays("train"), ours.batch_indices("train", B, seed=seed))
        jarrays = {k: jnp.asarray(v) for k, v in theirs.split_arrays("train").items()}
        want = [{k: np.asarray(jnp.take(v, jnp.asarray(sel), axis=0)) for k, v in jarrays.items()}
                for sel in theirs.batch_indices("train", B, seed=seed)]
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("stage", ["vae", "diffusion"])
def test_device_epoch_matches_jax_gather_scan(stage, monkeypatch):
    """`run_epoch_device` at k = 3 over 7 steps against the JAX
    `run_epoch_device(make_gather_scan_train_step(...))` on the same weights
    and split, the JAX step's draws (`jax_draws` of its own key splits) fed
    to the port: the update count, and each term's epoch mean within 1e-4
    relative."""
    data, system, opt, sched = ego(stage)
    condition = () if stage == "vae" else BOTH
    jsystem = JSystem(JConfig(condition=condition, **SMALL), j_synthetic_smpl(256),
                      data.mean, data.std)
    params = jax_params(system)
    arrays = ego_arrays(data, stage)
    index = list(data.batch_indices(2, seed=21))
    jopt = j_make_optimizer(stage, params, **OPT)
    state = create_train_state(params, jopt, jax.random.PRNGKey(3))
    rng, draws = state.rng, []
    for sel in index:
        rng, step_rng = jax.random.split(rng)
        draws.append(jax_draws(jsystem, stage, {k: v[sel] for k, v in arrays.items()}, step_rng))
    jdata = {k: jnp.asarray(v) for k, v in arrays.items()}
    state, jmeans = j_run_epoch_device(make_gather_scan_train_step(jsystem, stage, jopt), state,
                                       jdata, index, steps_per_dispatch=3)
    it = iter(draws)
    monkeypatch.setattr(system, "loss_draws", lambda *a, **k: next(it))
    count, means, steps, _ = run_epoch_device(system, stage, opt, sched, 0,
                                              make_device_data(arrays, "cpu"), index,
                                              steps_per_dispatch=3)
    assert count == int(state.step) == 7 and len(steps) == 7
    assert means.keys() == jmeans.keys()
    for k in means:
        np.testing.assert_allclose(means[k], jmeans[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("on_card", [True, False], ids=["card", "cpu"])
def test_dispatch_settings_defaults_and_keys(on_card):
    """Unset, the device route and 8 steps a fetch on the card, host batches
    and 1 on the CPU (`train.py:252-255, :283-285`); each key overrides."""
    tc = TrainConfig(stage="diffusion")
    assert dispatch_settings(tc, on_card) == ((True, 8) if on_card else (False, 1))
    assert dispatch_settings(dataclasses.replace(tc, device_data=not on_card), on_card)[0] \
        is (not on_card)
    assert dispatch_settings(dataclasses.replace(tc, steps_per_dispatch=3), on_card)[1] == 3
    assert dispatch_settings(dataclasses.replace(tc, steps_per_dispatch=0), on_card)[1] == 1


ROUTE_CASES = {
    # id: (argv, the route, k, a line of the log, the device split's keys)
    "cpu-default": (["--cfg", MLD, *TINY, "TRAIN.FEATURE_CACHE=true"], "host", 1,
                    "host batches (TRAIN.DEVICE_DATA off), 1 steps/dispatch", None),
    "device-data": (["--cfg", MLD, *TINY, "TRAIN.FEATURE_CACHE=true", "TRAIN.DEVICE_DATA=true"],
                    "device", 1, "GB on cpu, 1 steps/dispatch",
                    {"feats", "transl", "betas", "cam", "length", "scene_feats"}),
    "device-data-raw": (["--cfg", MLD, *TINY, "TRAIN.DEVICE_DATA=true",
                         "TRAIN.STEPS_PER_DISPATCH=4"], "device", 4,
                        "GB on cpu, 4 steps/dispatch",
                        {"feats", "transl", "betas", "cam", "length", "scene"}),
    "steps-only": (["--cfg", MLD, *TINY, "TRAIN.STEPS_PER_DISPATCH=4"], "host", 4,
                   "host batches (TRAIN.DEVICE_DATA off), 4 steps/dispatch", None),
    "size": (["--cfg", MLD, *TINY, "TRAIN.DEVICE_DATA=true", "TRAIN.DEVICE_DATA_MAX_GB=0.0001"],
             "host", 1, " GB > TRAIN.DEVICE_DATA_MAX_GB=0.0001; host batches, 1 steps/dispatch",
             None),
    "vae": (["--cfg", os.path.join(CONFIGS, "config_vae_egobody.yaml"), *TINY,
             "TRAIN.DEVICE_DATA=true"], "device", 1, "GB on cpu, 1 steps/dispatch",
            {"feats", "transl", "betas", "cam", "length"}),
    "preset": (["--preset", "mld_egobody", "train.device_data=True", "train.steps_per_dispatch=2",
                "model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
                "model.scene_points=64", "model.scene_feat_dim=32"], "device", 2,
               "GB on cpu, 2 steps/dispatch", {"feats", "transl", "betas", "cam", "length", "scene"}),
    "image-raw": (["--preset", "mld_egobody_image", "train.device_data=True",
                   "model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
                   "model.scene_points=64", "model.scene_feat_dim=32", "model.image_size=32"],
                  "host", 1, "device-resident split skipped: raw image crops are host work "
                  "(no image_feats cache); host batches, 1 steps/dispatch", None),
    "a2m": (["--cfg", os.path.join(CONFIGS, "config_mld_humanact12.yaml"), *TINY[:4],
             "model.num_frames=16", "TRAIN.DEVICE_DATA=true"], "device", 1,
            "GB on cpu, 1 steps/dispatch", {"motion", "action", "length"}),
}


def _trainer(argv, tmp_path):
    trainer = Trainer(parse_args([*argv[:2], "--device", "cpu", "--batch_size", "8",
                                  "--epochs", "1", *argv[2:], "--out", str(tmp_path)]))
    trainer.fill_feature_cache()
    return trainer


def _log(tmp_path):
    return open(tmp_path / "train_log.txt").read() if (tmp_path / "train_log.txt").exists() \
        else "".join(open(tmp_path / f).read() for f in os.listdir(tmp_path)
                     if f.endswith("_train.log"))


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_choice_and_log_lines(case, tmp_path):
    """The route the train CLI takes and the line it logs for: the CPU's
    defaults, each `TRAIN.*` key (`--cfg`) and their `train.*` fields
    (`--preset`), the size cut, stage 1, the image config without its
    feature cache, and an action config; the device split holds exactly
    the keys the stage reads."""
    argv, route, k, line, keys = ROUTE_CASES[case]
    trainer = _trainer(argv, tmp_path)
    data, got_k = trainer.dispatch()
    arrays, _ = trainer.device_split()
    trainer.close()
    assert ("host" if data is None else "device", got_k) == (route, k)
    assert line in _log(tmp_path)
    if case == "size":
        gb = sum(v.nbytes for v in arrays.values()) / 1e9
        assert f"device-resident split skipped: {gb:.4g}{line}" in _log(tmp_path)
    if data is not None:
        assert set(data) == keys
        assert f"device-resident train split: {sum(v.nbytes for v in data.values()) / 1e9:.3f}" \
            in _log(tmp_path)


def test_t2m_release_takes_the_host_route(tmp_path, monkeypatch):
    """A HumanML3D release encodes its captions on the host: the device
    route is skipped, with the reason in the log line, as `train.py`
    falls back from `split_arrays`' KeyError; the synthetic T2M split
    takes the device route."""
    write_release(tmp_path / "datasets" / "HumanML3D")
    monkeypatch.chdir(tmp_path)
    t2m = ["--cfg", os.path.join(CONFIGS, "config_mld_humanml3d.yaml"), "--batch_size", "2",
           *TINY[:4], "model.text_encoded_dim=48", "TRAIN.DEVICE_DATA=true"]
    trainer = Trainer(parse_args([*t2m[:2], "--device", "cpu", *t2m[2:], "--out",
                                  str(tmp_path / "release")]))
    assert not trainer.datamodule.is_synthetic
    assert trainer.dispatch() == (None, 1)
    trainer.close()
    assert ("device-resident split skipped: the release's captions are encoded on the host "
            "(data/humanml.py:132); host batches, 1 steps/dispatch") in _log(tmp_path / "release")
    os.rename(tmp_path / "datasets", tmp_path / "elsewhere")
    trainer = Trainer(parse_args([*t2m[:2], "--device", "cpu", *t2m[2:], "--out",
                                  str(tmp_path / "synthetic")]))
    data, _ = trainer.dispatch()
    trainer.close()
    assert set(data) == {"motion", "length", "text_emb"}


@pytest.mark.parametrize("first", ["device", "host"])
def test_checkpoint_resumes_across_routes(first, tmp_path):
    """Stage 1 with dropout on: 1 epoch on one route, a checkpoint, and a
    resume for the second epoch on the other, against 2 epochs straight on
    the first: the checkpoints' weights and optimizer state bitwise alike."""
    on = {"device": "TRAIN.DEVICE_DATA=true", "host": "TRAIN.DEVICE_DATA=false"}
    other = "host" if first == "device" else "device"
    base = ["--cfg", os.path.join(CONFIGS, "config_vae_egobody.yaml"), "--device", "cpu",
            "--batch_size", "8"]
    straight, cut = str(tmp_path / "straight"), str(tmp_path / "cut")
    a = train_main([*base, "--epochs", "2", *TINY, on[first], "TRAIN.STEPS_PER_DISPATCH=3",
                    "--out", straight])
    train_main([*base, "--epochs", "1", *TINY, on[first], "TRAIN.STEPS_PER_DISPATCH=3",
                "--out", cut])
    b = train_main([*base, "--epochs", "2", *TINY, on[other], "--out", cut, "--resume", cut])
    assert (a.route[0], b.route[0]) == (first, other)
    x = torch.load(os.path.join(straight, "checkpoints", "8.pt"), weights_only=False)
    y = torch.load(os.path.join(cut, "checkpoints", "8.pt"), weights_only=False)
    for k, v in x["state_dict"].items():
        assert torch.equal(v, y["state_dict"][k]), k
    for i, state in x["optimizer"]["state"].items():
        for k, v in state.items():
            assert torch.equal(v, y["optimizer"]["state"][i][k]), (i, k)


def test_device_route_under_ddp_matches_one_process(tmp_path):
    """The device route at k = 3 in two gloo ranks (each holds the whole
    split and gathers its rows of every index row) against the host route
    at k = 1 in the same two ranks and in one process: stage 2, cached
    scene features, dropout 0, 2 epochs at batch 8. Against the ranks'
    host route: every step's loss, each validation and the parameters
    bitwise. Against one process, as
    `test_torch_parallel_cli.py::test_train_cli_two_ranks_match_one_process`:
    losses and validations within 1e-4, alike on both ranks, the
    parameters equal across the ranks."""
    args = ["--cfg", MLD, "--device", "cpu", "--batch_size", "8", "--epochs", "2",
            "TRAIN.FEATURE_CACHE=true", "model.droupout=0.0", *TINY]
    run_world(train_cli, 2, str(tmp_path / "ranks"),
              [[*args, "TRAIN.DEVICE_DATA=true", "TRAIN.STEPS_PER_DISPATCH=3", "--out",
                str(tmp_path / "device")],
               [*args, "--out", str(tmp_path / "host")]])
    one = train_main([*args, "--out", str(tmp_path / "one")])
    assert one.route == ("host", 1)
    want = [s["total"] for r in one.history for s in r["steps"]]
    assert len(want) == 8
    for r in range(2):
        device, host = (np.load(tmp_path / "ranks" / f"rank{r}_{i}.npz") for i in range(2))
        for k in device.files:
            if k != "checkpoints":
                np.testing.assert_array_equal(device[k], host[k], err_msg=k)
        np.testing.assert_allclose(device["steps"], want, rtol=1e-4)
        np.testing.assert_allclose(device["val"], [h["val"]["total"] for h in one.history],
                                   rtol=1e-4)
    r0, r1 = (np.load(tmp_path / "ranks" / f"rank{r}_0.npz") for r in range(2))
    for k in r0.files:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert "device-resident train split" in _log(tmp_path / "device")
