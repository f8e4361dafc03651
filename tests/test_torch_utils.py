"""The port's `utils/` against the JAX package's on the CPU: the
experiment folder (the JAX layout under `<FOLDER>/torch`), the timestamped
logger, the optional writers being no-ops without their packages,
`StepTimer`'s printed means and `times.txt` on one sequence of clock
readings, `device_trace`'s Chrome trace, `memory_stats`' keys and host
RSS (5% of psutil's, which the JAX function reads), the YAML-subset config
snapshot against the JAX package's pyyaml one, and the train and test
CLIs' `--cfg` route writing the log, the snapshot and the memory line.
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from seeme_tpu.config.loader import load_config as j_load_config
from seeme_tpu.config.loader import save_config as j_save_config
from seeme_tpu.utils import logger as jlogger
from seeme_tpu.utils import profiling as jprofiling
from seeme_tpu_torch.config.loader import dump_yaml, load_config, load_yaml, save_config
from seeme_tpu_torch.test.__main__ import main as eval_cli
from seeme_tpu_torch.train.__main__ import main as train_cli
from seeme_tpu_torch.utils import logger, profiling
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
TINY_A2M = ["model.latent_dim=[1,32]", "model.ff_size=16", "model.num_layers=3",
            "DATASET.NUM_FRAMES=16"]


def test_experiment_dir_is_the_jax_layout_under_torch(tmp_path):
    path = os.path.join(CONFIGS, "config_mld_humanml3d.yaml")
    over = {"FOLDER": str(tmp_path / "exp")}
    ours = logger.create_experiment_dir(load_config(path, overrides=over))
    ref = jlogger.create_experiment_dir(j_load_config(path, overrides=over))
    assert os.path.isdir(ours) and os.path.isdir(ref)
    folder, rest = str(tmp_path / "exp"), os.path.relpath(ref, tmp_path / "exp")
    assert ours == os.path.join(folder, "torch", rest) == os.path.join(folder, "torch", "mld",
                                                                       "s2_humanml3d")


def test_logger_writes_one_timestamped_file(tmp_path):
    for _ in range(2):  # a second logger replaces the first's handlers
        log = logger.create_logger(str(tmp_path), phase="test")
    log.info("hello %d", 3)
    for h in log.handlers:
        h.flush()
    files = glob.glob(str(tmp_path / "*_test.log"))
    assert len(files) == 1 and open(files[0]).read().count("hello 3") == 1
    assert len(log.handlers) == 2 and not log.propagate


def test_writers_are_no_ops_without_their_packages(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "wandb", None)
    tb = logger.TensorBoardWriter(str(tmp_path))
    tb.scalars(1, {"a": 1.0})
    tb.close()
    assert not os.path.exists(tmp_path / "tb")
    cfg = load_config(os.path.join(CONFIGS, "config_mld_humanml3d.yaml"),
                      overrides={"LOGGER": {"WANDB": {"PROJECT": "p"}}})
    wb = logger.WandbLogger(cfg, str(tmp_path))
    wb.log(1, {"a": 1.0})
    wb.finish()
    assert wb._run is None
    assert logger.WandbLogger(load_config(os.path.join(CONFIGS, "config_mld_humanml3d.yaml")),
                              str(tmp_path))._run is None  # PROJECT null


def test_step_timer_keeps_the_times_contract(tmp_path, monkeypatch, capsys):
    """Both timers on one sequence of clock readings print the same means
    and dump the same `times.txt`."""
    ticks = [0.0, 0.5, 1.0, 1.25, 2.0, 2.125, 3.0, 3.5]
    outputs = []
    for mod, name in ((profiling, "ours"), (jprofiling, "ref")):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(batch_size=4, print_every=2)
        for _ in range(4):
            with timer:
                pass
        timer.dump(str(tmp_path / f"{name}.txt"))
        outputs.append((capsys.readouterr().out, open(tmp_path / f"{name}.txt").read()))
    assert outputs[0] == outputs[1]
    assert outputs[0][1].splitlines() == ["0.5", "0.25", "0.125", "0.5"]
    assert "2 iter mean Time (batch_size: 4)" in outputs[0][0]


def test_device_trace_and_memory_stats(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof is not None and os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    with profiling.device_trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not os.path.exists(tmp_path / "off")
    ours, ref = profiling.memory_stats(torch.device("cpu")), jprofiling.memory_stats()
    assert set(ours) == set(ref) == {"host_rss_gb"}
    np.testing.assert_allclose(ours["host_rss_gb"], ref["host_rss_gb"], rtol=0.05)


@pytest.mark.parametrize("name", ["config_mld_egobody.yaml", "config_mld_humanml3d.yaml",
                                  "config_vae_uestc.yaml"])
def test_config_snapshot_matches_the_jax_one(tmp_path, name):
    path = os.path.join(CONFIGS, name)
    save_config(load_config(path), str(tmp_path / "ours.yaml"))
    j_save_config(j_load_config(path), str(tmp_path / "ref.yaml"))
    ours = yaml.safe_load(open(tmp_path / "ours.yaml"))
    assert ours == yaml.safe_load(open(tmp_path / "ref.yaml"))
    assert load_yaml(tmp_path / "ours.yaml") == ours  # the port reads its own snapshot
    assert dump_yaml({"a": 1e-5, "b": {}, "c": ["x", None, 2]}) == \
        'a: 1.0e-05\nb: null\nc: ["x", null, 2]'


def test_cfg_route_writes_log_snapshot_and_memory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # FOLDER ./experiments
    yaml_path = os.path.join(CONFIGS, "config_vae_humanact12.yaml")
    trainer = train_cli(["--cfg", yaml_path, "--device", "cpu", "--epochs", "1",
                         "LOGGER.TENSORBOARD=false"] + TINY_A2M)
    exp = tmp_path / "experiments" / "torch" / "mld" / "s1_humanact12"
    assert trainer.exp_dir == str(exp)
    assert len(glob.glob(str(exp / "*_train.log"))) == 1
    assert "epoch 0/1" in open(glob.glob(str(exp / "*_train.log"))[0]).read()
    assert load_yaml(exp / "config.yaml")["NAME"] == "s1_humanact12"
    assert set(trainer.history[0]["memory"]) == {"host_rss_gb"}
    assert "host_rss_gb=" in open(exp / "train_log.txt").read()
    out = tmp_path / "given"
    eval_cli(["--cfg", yaml_path, "--device", "cpu", "--out", str(out),
              "model.scheduler.num_inference_timesteps=2"] + TINY_A2M)
    assert len(glob.glob(str(out / "*_test.log"))) == 1  # --out wins over the YAML's folder
