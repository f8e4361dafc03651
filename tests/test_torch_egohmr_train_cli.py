"""The EgoHMR training CLI of the port against the root `train_egohmr.py`
(helpers in `torch_egohmr_train_common.py`; see `test_torch_egohmr_train.py`).
"""

import sys

import jax
import numpy as np

from seeme_tpu.models.egohmr import EgoHmr as JEgoHmr
from seeme_tpu_torch import test_egohmr, train_egohmr as cli
from seeme_tpu_torch.convert import egohmr_state_dict
from seeme_tpu_torch.models.egohmr import EgoHmr
from test_torch_hmr import POINTS, jx, root_script
from test_torch_prohmr_train import loading_init
from torch_egohmr_train_common import (
    egohmr,
    jax_draws,
)
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)


def test_cli_matches_jax_root_script(egohmr, monkeypatch, capsys, tmp_path):
    """Both CLIs from the same weights on the same augmented data, two
    epochs of two steps, the port's draws replayed from the JAX CLI's keys:
    the printed epoch losses and MSEs within 1e-4 relative (plus half the
    last printed digit); the checkpoint loads into the port's test CLI.
    Learning rate 1e-8 for the reason `tests/test_torch_prohmr_train.py`
    gives; the update is held to optax above."""
    jm, tree, _ = egohmr
    monkeypatch.setattr(JEgoHmr, "init_params", lambda self, rng: jx(tree))
    argv = ["--tiny", "--batch_size", "32", "--epochs", "2", "--lr", "1e-8",
            "--scene_points", str(POINTS), "--out", str(tmp_path / "jax")]
    monkeypatch.setattr(sys, "argv", ["train_egohmr.py", *argv, "--cpu"])
    root_script("train_egohmr").main()
    want = [line for line in capsys.readouterr().out.splitlines() if line.startswith("epoch")]

    keys, rng = [], jax.random.PRNGKey(1)
    for _ in range(4):
        rng, step = jax.random.split(rng)
        keys.append(step)
    monkeypatch.setattr(EgoHmr, "__init__", loading_init(EgoHmr.__init__, egohmr_state_dict(tree)))
    argv[-1] = str(tmp_path / "port")
    got = cli.main([*argv, "--device", "cpu"], draws=lambda i: jax_draws(jm, keys[i], 32))
    assert len(want) == 2
    for line, loss, mse in zip(want, got["losses"], got["mse"]):
        wl = float(line.split("loss ")[1].split()[0])
        wm = float(line.split("mse ")[1].split(",")[0])
        assert abs(loss - wl) <= 1e-4 * abs(wl) + 5e-5, (loss, wl)
        assert abs(mse - wm) <= 1e-4 * abs(wm) + 5e-5, (mse, wm)
    monkeypatch.undo()
    metrics = test_egohmr.main(["--tiny", "--device", "cpu", "--scene_points", str(POINTS),
                                "--checkpoint", got["checkpoint"]])
    assert all(np.isfinite(v) for v in metrics.values())
