"""Checkpoints with the reference's experiment-folder layout
(`seeme_tpu/train/checkpoint.py`), as torch files.

`<exp>/checkpoints/<step>.pt` holds the system's state dict under the
reference keys (`vae.*`, `denoiser.*`, `proscene.scene_enc.*`,
`output_scene.1.*`), the optimizer state, the step, the epoch, and the
random generators' states (the loss draws' generator and torch's default
ones, which drive dropout), so a resumed run continues bit for bit. Stage 2
takes only the `vae.*` keys of a stage-1 checkpoint (`train.py:155-167`).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

_STEP = re.compile(r"(\d+)\.pt")


def checkpoint_dir(exp_dir: str) -> str:
    return os.path.join(os.path.abspath(os.path.expanduser(exp_dir)), "checkpoints")


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(m.group(1)) for m in map(_STEP.fullmatch, os.listdir(ckpt_dir)) if m]


def _rng_states(generator: Optional[torch.Generator]) -> Dict:
    states = {"cpu": torch.get_rng_state()}
    if torch.cuda.is_available():
        states["cuda"] = torch.cuda.get_rng_state_all()
    if generator is not None:
        states["generator"] = generator.get_state()
    return states


def clear_stale_steps(exp_dir: str) -> int:
    """Delete `<step>.pt` files an earlier run left in `exp_dir`, so that
    `checkpoints/latest` cannot resolve to them; a fresh (non-resume) run
    calls this, as the JAX trainer purges its stale step dirs. Returns the
    count deleted."""
    ckpt = checkpoint_dir(exp_dir)
    stale = _steps(ckpt)
    for step in stale:
        os.remove(os.path.join(ckpt, f"{step}.pt"))
    return len(stale)


def save_state(exp_dir: str, system: nn.Module, optimizer: torch.optim.Optimizer, step: int,
               epoch: int, generator: Optional[torch.Generator] = None) -> str:
    ckpt = checkpoint_dir(exp_dir)
    os.makedirs(ckpt, exist_ok=True)
    path = os.path.join(ckpt, f"{step}.pt")
    torch.save({"state_dict": system.state_dict(), "optimizer": optimizer.state_dict(),
                "step": int(step), "epoch": int(epoch), "rng": _rng_states(generator)},
               path + ".tmp")
    os.replace(path + ".tmp", path)  # a cut run leaves no half-written step
    return path


def restore_state(path: str, system: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
                  generator: Optional[torch.Generator] = None) -> Tuple[int, int]:
    """Load a checkpoint file, or an experiment dir's latest one, into the
    system, the optimizer and the generators; returns (step, epoch)."""
    ckpt = torch.load(checkpoint_file(path), map_location="cpu", weights_only=False)
    system.load_state_dict(ckpt["state_dict"])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    rng = ckpt["rng"]
    torch.set_rng_state(rng["cpu"])
    if "cuda" in rng and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(rng["cuda"])
    if generator is not None and "generator" in rng:
        generator.set_state(rng["generator"])
    return ckpt["step"], ckpt["epoch"]


def latest_checkpoint_step(exp_dir: str) -> Optional[int]:
    steps = _steps(checkpoint_dir(exp_dir))
    return max(steps) if steps else None


def resolve_latest(path: str) -> str:
    """'.../checkpoints/latest' -> the highest '<step>.pt' beside it (the
    configs' PRETRAINED_VAE contract; no file named 'latest' is written).
    Any other path passes through unchanged."""
    if os.path.basename(path) != "latest":
        return path
    steps = _steps(os.path.dirname(path))
    return os.path.join(os.path.dirname(path), f"{max(steps)}.pt") if steps else path


def normalize_resume_dir(resume: str) -> str:
    """A resume spelling (the experiment dir, its `checkpoints/` dir, or a
    `<step>.pt` / `latest` entry in it) -> the experiment dir."""
    r = os.path.abspath(os.path.expanduser(resume))
    base = os.path.basename(r)
    if (_STEP.fullmatch(base) or base == "latest") and \
            os.path.basename(os.path.dirname(r)) == "checkpoints":
        r = os.path.dirname(r)
    if os.path.basename(r) == "checkpoints":
        r = os.path.dirname(r)
    return r


def resume_scan(exp_dir: str) -> Tuple[Optional[str], Optional[int]]:
    """(config snapshot, latest step) of an experiment dir (`train.py:26-53`)."""
    cfg = os.path.join(exp_dir, "config.json")
    return (cfg if os.path.exists(cfg) else None), latest_checkpoint_step(exp_dir)


def checkpoint_file(path: str) -> str:
    """The `<step>.pt` file a checkpoint spelling names: the file itself,
    an experiment dir (its latest step) or '.../checkpoints/latest'; raises
    FileNotFoundError when there is none."""
    if os.path.isdir(path):
        step = latest_checkpoint_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir(path)}")
        return os.path.join(checkpoint_dir(path), f"{step}.pt")
    path = resolve_latest(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint {path} does not exist")
    return path


def load_weights(path: str, system: nn.Module) -> str:
    """Load a checkpoint's state dict into `system`, strictly, and nothing
    else (no optimizer, no generator state); returns the file read."""
    path = checkpoint_file(path)
    system.load_state_dict(torch.load(path, map_location="cpu", weights_only=False)["state_dict"])
    return path


def load_pretrained_vae(path: str, system: nn.Module) -> int:
    """Graft the `vae.*` keys of a checkpoint (a `<step>.pt` file or
    '.../checkpoints/latest') into `system.vae`, strictly; returns the count
    of tensors loaded. Raises KeyError when the checkpoint has no VAE."""
    ckpt = torch.load(resolve_latest(path), map_location="cpu", weights_only=False)
    donor = ckpt.get("state_dict", ckpt)
    vae = {k[len("vae."):]: v for k, v in donor.items() if k.startswith("vae.")}
    if not vae:
        raise KeyError(f"checkpoint {path} has no 'vae.*' keys: {sorted(donor)[:5]}...")
    system.vae.load_state_dict(vae, strict=True)
    return len(vae)
