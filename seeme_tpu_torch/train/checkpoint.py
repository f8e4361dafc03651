"""Checkpoints with the reference's experiment-folder layout
(`seeme_tpu/train/checkpoint.py`), as torch files.

`<exp>/checkpoints/<step>.pt` holds the system's state dict under the
reference keys (`vae.*`, `denoiser.*`, `proscene.scene_enc.*`,
`output_scene.1.*`), the optimizer state, the step, the epoch, and the
random generators' states (the loss draws' generator and torch's default
ones, which drive dropout), so a resumed run continues bit for bit. Stage 2
takes only the `vae.*` keys of a stage-1 checkpoint (`train.py:155-167`).

A data-parallel run's checkpoint (written by rank 0) also holds its world
size and every rank's default generators, which differ by rank (dropout
draws on each rank's rows); a resume at the same world size restores each
rank's own, and one at another size raises.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

_STEP = re.compile(r"(\d+)\.pt")


def checkpoint_dir(exp_dir: str) -> str:
    return os.path.join(os.path.abspath(os.path.expanduser(exp_dir)), "checkpoints")


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(m.group(1)) for m in map(_STEP.fullmatch, os.listdir(ckpt_dir)) if m]


def default_rng_states() -> Dict:
    """This process's default generators: the CPU's and every card's."""
    states = {"cpu": torch.get_rng_state()}
    if torch.cuda.is_available():
        states["cuda"] = torch.cuda.get_rng_state_all()
    return states


def _rng_states(generator: Optional[torch.Generator]) -> Dict:
    states = default_rng_states()
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


def step_path(exp_dir: str, step: int) -> str:
    return os.path.join(checkpoint_dir(exp_dir), f"{step}.pt")


def save_state(exp_dir: str, system: nn.Module, optimizer: torch.optim.Optimizer, step: int,
               epoch: int, generator: Optional[torch.Generator] = None,
               rank_states: Optional[List[Dict]] = None) -> str:
    """Write `<step>.pt`; `rank_states` is every rank's `default_rng_states`,
    in rank order, of a data-parallel run."""
    os.makedirs(checkpoint_dir(exp_dir), exist_ok=True)
    path = step_path(exp_dir, step)
    state = {"state_dict": system.state_dict(), "optimizer": optimizer.state_dict(),
             "step": int(step), "epoch": int(epoch), "rng": _rng_states(generator)}
    if rank_states is not None:
        state["world"] = len(rank_states)
        state["rng"]["ranks"] = rank_states
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)  # a cut run leaves no half-written step
    return path


def restore_state(path: str, system: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
                  generator: Optional[torch.Generator] = None, rank: int = 0,
                  world: int = 1) -> Tuple[int, int]:
    """Load a checkpoint file, or an experiment dir's latest one, into the
    system, the optimizer and the generators (the default ones of `rank`);
    returns (step, epoch). Raises when the checkpoint was written at another
    world size."""
    path = checkpoint_file(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    saved = ckpt.get("world", 1)
    if saved != world:
        raise ValueError(f"checkpoint {path} was written by a run of world size {saved}; "
                         f"this run has world size {world}: resume it at world size {saved}")
    system.load_state_dict(ckpt["state_dict"])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    rng = ckpt["rng"]
    own = rng["ranks"][rank] if "ranks" in rng else rng
    torch.set_rng_state(own["cpu"])
    if "cuda" in own and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(own["cuda"])
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
