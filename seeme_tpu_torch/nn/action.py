"""Action-class conditioning of the HumanAct12 / UESTC action-to-motion
configs (`seeme_tpu/nn/action.py`, the reference's `EmbedAction`,
`mld_denoiser.py:247-296`). The drop probability is the system's
(`A2MConfig.guidance_uncondp`), not the module's.

A learned table of one `latent_dim` row per class, xavier-uniform at
init: (B,) class ids -> (B, 1, D), one condition token. `force_mask`
zeroes it (the unconditional half under classifier-free guidance). In
training whole samples lose their token with probability
`guidance_uncondp`; the (B, 1) mask of dropped samples is drawn by the
loss (`models/a2m.py::A2MSystem.loss_draws`) and passed in as `drop`, so a
check can inject the JAX package's draw.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class EmbedAction(nn.Module):
    def __init__(self, num_actions: int, latent_dim: int):
        super().__init__()
        self.action_embedding = nn.Parameter(torch.empty(num_actions, latent_dim))

    def forward(self, action_ids: torch.Tensor, force_mask: bool = False,
                drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """action_ids (B,) ints; drop (B, 1), True = the sample's token is
        zeroed (ignored with `force_mask`) -> (B, 1, D)."""
        out = self.action_embedding[action_ids.long()]
        if force_mask:
            out = torch.zeros_like(out)
        elif drop is not None:
            out = out * (1.0 - drop.to(out.dtype))
        return out[:, None, :]
