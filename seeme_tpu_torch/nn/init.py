"""Seeded parameter initialization and perturbation with explicit generators.

`init_parameters_` follows the reference's init rules: xavier-uniform
weights, zero biases, unit LayerNorm and batch-norm scales, batch-norm
statistics (0, 1), LeCun-normal convolution kernels (flax's `nn.Conv`
default), N(0, 1) distribution tokens, U[0, 1) learned positional
encodings, and zeros for the zero-initialized
output projections (stylization `out_layers`, the stylized FFN's `linear2`,
the PointNet blocks' `fc_1`). `perturb_parameters_` adds seeded noise so
those zeroed branches carry signal in a check.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .resnet import FrozenBatchNorm2d

_ZERO_INIT = ("out_layers.2.weight", "ffn.linear2.weight", "fc_1.weight")
PERTURB_SCALE = 0.02  # std of the noise perturb_parameters_ adds


@torch.no_grad()
def init_parameters_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    norm_params = {
        id(p) for m in module.modules() if isinstance(m, (nn.LayerNorm, FrozenBatchNorm2d))
        for p in m.parameters(recurse=False)
    }
    for name, p in module.named_parameters():
        cpu = torch.empty(p.shape, dtype=p.dtype)
        if id(p) in norm_params:
            cpu.fill_(1.0 if name.endswith(("weight", "running_var")) else 0.0)
        elif name.endswith("global_motion_token"):
            cpu.normal_(0.0, 1.0, generator=generator)
        elif name.endswith(".pe") or name == "pe":
            cpu.uniform_(0.0, 1.0, generator=generator)
        elif p.ndim == 1 or name.endswith(_ZERO_INIT):
            cpu.zero_()
        elif p.ndim == 4:  # a convolution (out, in, kh, kw)
            cpu.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=generator)
        else:
            fan_out, fan_in = p.shape[0], p.shape[1]
            a = math.sqrt(6.0 / (fan_in + fan_out))
            cpu.uniform_(-a, a, generator=generator)
        p.copy_(cpu)
    return module


@torch.no_grad()
def perturb_parameters_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded noise on every parameter but the batch-norm statistics, which
    are parameters only so that training can update them."""
    stats = {id(t) for m in module.modules() if isinstance(m, FrozenBatchNorm2d)
             for t in (m.running_mean, m.running_var)}
    for p in module.parameters():
        if id(p) not in stats:
            p.add_(PERTURB_SCALE * torch.randn(p.shape, generator=generator).to(p.device))
    return module
