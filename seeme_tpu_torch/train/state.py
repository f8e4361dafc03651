"""Stage freeze sets, the StepLR schedule and the optimizer
(`seeme_tpu/train/state.py`).

The reference trains with AdamW and a per-epoch StepLR (`mld.py:292-299`;
`configs/config_mld_egobody.yaml:19-23`: lr 1e-4, step size 6000 epochs,
gamma 0.2). Stage 2 freezes the VAE and the perception encoder
(`mld.py:185-208, 267-271`). Frozen subtrees get `requires_grad=False`, no
optimizer state and no weight decay, which is what the JAX package's
`optax.set_to_zero` mask does to them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

# Subtrees of the system that train in each stage (`seeme_tpu/train/state.py:21-28`);
# the port's SeeMeSystem has the first two of the stage-2 set.
STAGE_TRAINABLE = {
    "vae": ("vae",),
    "diffusion": ("denoiser", "output_scene", "output_images", "embed_action"),
}


def step_lr_schedule(base_lr: float, step_size_epochs: int, gamma: float,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """torch StepLR over epochs: lr * gamma ** (epoch // step_size), where
    the epoch is `count // steps_per_epoch` and `count` is the number of
    updates made before this one, as optax counts."""

    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return base_lr * gamma ** (epoch // step_size_epochs)

    return schedule


def set_stage(system: nn.Module, stage: Optional[str]) -> List[nn.Parameter]:
    """Freeze the whole system in eval mode, then give the stage's trainable
    subtrees gradients and train mode (dropout on); returns their
    parameters. `stage=None` leaves everything frozen in eval mode, the
    sampling default."""
    system.requires_grad_(False)
    system.eval()
    if stage is None:
        return []
    params = []
    for key in STAGE_TRAINABLE[stage]:
        sub = getattr(system, key, None)
        if sub is None:  # a subtree this configuration does not build
            continue
        sub.requires_grad_(True)
        sub.train()
        params += list(sub.parameters())
    return params


def make_optimizer(stage: str, system: nn.Module, lr: float = 1e-4,
                   step_size_epochs: int = 6000, gamma: float = 0.2, steps_per_epoch: int = 1,
                   ) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    """`set_stage`, then AdamW over the stage's trainable parameters only,
    with the betas (0.9, 0.999), eps 1e-8 and weight decay 1e-2 the JAX
    package gives optax; returns (optimizer, schedule). `loop.train_step` sets the learning rate
    from the schedule before every update. `foreach` updates the parameters
    in place with ops that bump their version counters, which key the
    kernel-layout weight copies (`ops/__init__.py::tensor_versions`)."""
    params = set_stage(system, stage)
    optimizer = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-2, foreach=True)
    return optimizer, step_lr_schedule(lr, step_size_epochs, gamma, steps_per_epoch)
