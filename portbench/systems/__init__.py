"""The system under test, built from a configuration file through the port's
own `--cfg` route (`seeme_tpu_torch/config/build.py`), and what the benchmark
makes for it from the run's seed: the weights, the SMPL body and the feature
statistics. All are made on the device in a few large calls; the program
gets copies (`load_state_dict`), the reference reads the benchmark's own.

Each system family is a module of this package, found by the name a
configuration file gives under `system` (`seeme.py`, `t2m.py`); a new family
is a new module.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from portbench.reference.plain import SMPL_PARENTS


def subseed(seed: int, tag: str, index: int = 0) -> int:
    """A 63-bit seed of its own for each (run seed, stream, index)."""
    digest = hashlib.blake2b(f"{seed}:{tag}:{index}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def generator(seed: int, tag: str, device, index: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag, index))


def as_loader_config(tree):
    """A nested dict as the port's loader gives it (`config/loader.py::Config`)."""
    from seeme_tpu_torch.config.loader import Config

    if isinstance(tree, dict):
        return Config({k: as_loader_config(v) for k, v in tree.items()})
    return tree


@torch.no_grad()
def make_weights(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every floating tensor of a state dict, from one draw on the device:
    a matrix (or table) of standard deviation 1 / sqrt(fan_in), fan_in its
    row length; a LayerNorm scale 1 + 0.1 N(0, 1); a bias 0.1 N(0, 1). No
    tensor is zero, so no branch of the model is trivially off."""
    names = list(shapes)
    counts = [math.prod(shapes[n]) for n in names]
    scale, shift = [], []
    for n in names:
        shape = shapes[n]
        if len(shape) >= 2:
            scale.append(1.0 / math.sqrt(math.prod(shape[1:])))
            shift.append(0.0)
        else:
            scale.append(0.1)
            shift.append(1.0 if n.endswith("weight") else 0.0)
    reps = torch.tensor(counts, device=device)
    flat = torch.randn(sum(counts), generator=generator(seed, "weights", device), device=device)
    flat = (flat * torch.repeat_interleave(torch.tensor(scale, device=device), reps)
            + torch.repeat_interleave(torch.tensor(shift, device=device), reps))
    return {n: t.view(shapes[n]) for n, t in zip(names, flat.split(counts))}


@torch.no_grad()
def make_body(seed: int, device, vertices: int = 6890, betas: int = 10) -> Dict[str, torch.Tensor]:
    """A synthetic SMPL body with the model's structure: template, shape and
    pose blend shapes, a sparse positive joint regressor with rows summing
    to one, skinning weights, and SMPL's kinematic tree."""
    g = generator(seed, "smpl", device)
    V = vertices
    j = torch.randn(24, V, generator=g, device=device).abs()
    j = j * (torch.rand(24, V, generator=g, device=device) < 8.0 / V) + 1e-4
    lbs = torch.randn(V, 24, generator=g, device=device).abs() ** 4
    return {
        "v_template": torch.randn(V, 3, generator=g, device=device) * 0.3,
        "shapedirs": torch.randn(V, 3, betas, generator=g, device=device) * 0.01,
        "posedirs": torch.randn(207, V * 3, generator=g, device=device) * 0.001,
        "j_regressor": j / j.sum(1, keepdim=True),
        "lbs_weights": lbs / lbs.sum(1, keepdim=True),
        "parents": torch.tensor(SMPL_PARENTS, dtype=torch.int64, device=device),
    }


@torch.no_grad()
def make_stats(seed: int, n: int, device):
    """Feature mean and standard deviation, (n,) each."""
    g = generator(seed, "stats", device)
    return (torch.randn(n, generator=g, device=device) * 0.1,
            0.5 + 0.5 * torch.rand(n, generator=g, device=device))


@dataclass
class Built:
    system: torch.nn.Module          # the port's system (the program)
    weights: Dict[str, torch.Tensor]  # the benchmark's weights, the program's copied from them
    body: Optional[Dict[str, torch.Tensor]]
    mean: torch.Tensor
    std: torch.Tensor


def build(conf: Dict, seed: int, device) -> Built:
    """The configuration's system on `device` with the benchmark's weights:
    `systems/<conf["system"]>.py`'s `make(conf, tree, seed, device)` builds
    it from the loader's view of the configuration and returns (system,
    SMPL body or None, feature mean, feature std)."""
    from seeme_tpu_torch._device import full_float32

    from portbench import registry

    full_float32()
    system, body, mean, std = registry.system(conf["system"]).make(
        conf, as_loader_config(conf["config"]), seed, device)
    shapes = {k: v.shape for k, v in system.state_dict().items() if v.is_floating_point()}
    weights = make_weights(shapes, seed, device)
    system.load_state_dict(weights, strict=True)
    return Built(system, weights, body, mean, std)
