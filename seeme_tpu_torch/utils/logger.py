"""Experiment folders and logging (`seeme_tpu/utils/logger.py`, the
reference's `mld/utils/logger.py:9-72` layout): `<FOLDER>/torch/<model_type>/<NAME>/`
with a timestamped log file and a config snapshot, and the optional
TensorBoard and Weights & Biases writers, each a no-op when its package is
absent (the card's machine has neither).

The port's folders sit under `<FOLDER>/torch`, beside the JAX package's
`<FOLDER>/<model_type>/<NAME>`, so the two packages' checkpoints and logs
never share a directory.
"""

from __future__ import annotations

import logging
import os
import time


def create_experiment_dir(cfg, phase: str = "train") -> str:
    folder = str(cfg.get("FOLDER", "./experiments"))
    model_type = str(cfg.select("model.model_type", "mld"))
    name = str(cfg.get("NAME", "exp"))
    exp_dir = os.path.join(folder, "torch", model_type, name)
    os.makedirs(exp_dir, exist_ok=True)
    return exp_dir


def create_logger(exp_dir: str, phase: str = "train") -> logging.Logger:
    """A logger writing `<stamp>_<phase>.log` in `exp_dir` and to stderr."""
    stamp = time.strftime("%Y-%m-%dT%H-%M-%S")
    logger = logging.getLogger(f"seeme_tpu_torch.{phase}")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s %(message)s")
    for h in (logging.FileHandler(os.path.join(exp_dir, f"{stamp}_{phase}.log")),
              logging.StreamHandler()):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


class TensorBoardWriter:
    """Scalars into `<exp_dir>/tb`; a no-op when tensorboardX is absent."""

    def __init__(self, exp_dir: str, enabled: bool = True):
        self._w = None
        if enabled:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            self._w = SummaryWriter(os.path.join(exp_dir, "tb"))

    def scalars(self, step: int, values: dict, prefix: str = "") -> None:
        if self._w is None:
            return
        for k, v in values.items():
            self._w.add_scalar(f"{prefix}{k}", float(v), step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()


class WandbLogger:
    """Weights & Biases logging (`train.py:63-84` in the reference); a no-op
    when wandb is not installed or LOGGER.WANDB.PROJECT is null."""

    def __init__(self, cfg, exp_dir: str):
        self._run = None
        project = cfg.select("LOGGER.WANDB.PROJECT", None)
        if not project:
            return
        try:
            import wandb
        except ImportError:
            return
        self._run = wandb.init(
            project=str(project),
            entity=cfg.select("LOGGER.WANDB.ENTITY", None),
            group=cfg.select("LOGGER.WANDB.GROUP", None),
            dir=exp_dir,
            mode="offline" if cfg.select("LOGGER.WANDB.OFFLINE", False) else "online",
            resume="allow",
            id=cfg.select("LOGGER.WANDB.RESUME_ID", None),
            config=dict(cfg),
        )

    def log(self, step: int, values: dict, prefix: str = "") -> None:
        if self._run is not None:
            self._run.log({f"{prefix}{k}": float(v) for k, v in values.items()}, step=step)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
