"""The one generator of every traffic mix: a mix is a data file of parameters
(`traffic/<mix>.json`) that this module reads. Batch i of a run is made on
the device from (seed, i) alone, so the reference can make it again after
the window; the initial noise of batch i comes from a stream of its own.

What a batch holds is the mix's `generator`, a module of
`portbench/generators/` found by that name (`ego.py`, `text.py`); its
`batch(traffic, i)` reads the mix's parameters and the cell's
configuration.
"""

from __future__ import annotations

from typing import Dict

import torch

from .systems import generator


class Traffic:
    def __init__(self, mix: Dict, conf: Dict, seed: int, device):
        from portbench import registry

        self.mix, self.conf, self.seed, self.device = mix, conf, seed, device
        self.batch_size = int(mix["batch"])
        self.latent = tuple(conf["config"]["model"]["latent_dim"])
        self._make = registry.generator(mix["generator"]).batch

    def noise(self, i: int) -> torch.Tensor:
        """Batch i's initial DDIM noise, (B, latent tokens, width)."""
        g = generator(self.seed, "noise", self.device, i)
        return torch.randn((self.batch_size, *self.latent), generator=g, device=self.device)

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        """Batch i, made from (seed, i) alone."""
        return self._make(self, i)
