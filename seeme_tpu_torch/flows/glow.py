"""Conditional Glow normalizing flow (`seeme_tpu/flows/glow.py`), with the
parameter names of the nflows modules the reference checkpoints hold.

Per layer ActNorm -> LULinear -> AdditiveCoupling(ResidualNet(context)),
alternating coupling masks, standard-normal base, in a `_transform.
_transforms` list at slots 3i, 3i + 1, 3i + 2 (`tools/convert_checkpoint.py
::convert_glow`). The residual nets run their batch norm with running
statistics (dropout is off); with `use_batch_norm=False` a block has no
batch norm and no `batch_norm_layers` keys (`seeme_tpu/flows/glow.py:49,
:102-104, :156-163`). `initialize_actnorm` is the data-dependent ActNorm
start of training.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.resnet import FrozenBatchNorm2d

LU_EPS = 1e-3  # LULinear's floor on U's diagonal
BN_EPS = 1e-5  # the residual nets' batch norm


@dataclass(frozen=True)
class GlowConfig:
    features: int = 144
    hidden_features: int = 1024
    num_layers: int = 4
    num_blocks_per_layer: int = 2
    context_features: Optional[int] = None
    use_batch_norm: bool = True  # the residual blocks' batch norm

    def masks(self) -> np.ndarray:
        """Per-layer coupling masks: -1 at even indices in layer 0, flipped
        each layer (`seeme_tpu/flows/glow.py:55-65`)."""
        mask = np.ones(self.features)
        mask[::2] = -1
        out = []
        for _ in range(self.num_layers):
            out.append(mask.copy())
            mask = -mask
        return np.stack(out)


class ActNorm(nn.Module):
    """y = exp(log_scale) x + shift; logabsdet = sum(log_scale)."""

    def __init__(self, features: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.zeros(features))
        self.shift = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        logdet = self.log_scale.sum().expand(x.shape[0])
        return torch.exp(self.log_scale) * x + self.shift, logdet

    def inverse(self, x):
        logdet = -self.log_scale.sum().expand(x.shape[0])
        return (x - self.shift) / torch.exp(self.log_scale), logdet


class LULinear(nn.Module):
    """W = L U, L unit lower triangular, U upper with softplus(diag) + eps;
    y = L (U x) + b, inverted by two triangular solves."""

    def __init__(self, features: int):
        super().__init__()
        n_tri = features * (features - 1) // 2
        self.features = features
        self.lower_entries = nn.Parameter(torch.zeros(n_tri))
        self.upper_entries = nn.Parameter(torch.zeros(n_tri))
        self.unconstrained_upper_diag = nn.Parameter(
            torch.full((features,), math.log(math.exp(1 - LU_EPS) - 1)))
        self.bias = nn.Parameter(torch.zeros(features))

    def upper_diag(self):
        return F.softplus(self.unconstrained_upper_diag) + LU_EPS

    def matrices(self) -> Tuple[torch.Tensor, torch.Tensor]:
        D, dev = self.features, self.bias.device
        li = torch.tril_indices(D, D, offset=-1, device=dev)
        ui = torch.triu_indices(D, D, offset=1, device=dev)
        zeros = self.bias.new_zeros(D, D)
        lower = zeros.index_put((li[0], li[1]), self.lower_entries) + torch.eye(D, device=dev)
        upper = zeros.index_put((ui[0], ui[1]), self.upper_entries)
        return lower, upper + torch.diag(self.upper_diag())

    def forward(self, x):
        lower, upper = self.matrices()
        logdet = torch.log(self.upper_diag()).sum().expand(x.shape[0])
        return (x @ upper.T) @ lower.T + self.bias, logdet

    def inverse(self, x):
        lower, upper = self.matrices()
        out = torch.linalg.solve_triangular(lower, (x - self.bias).T, upper=False,
                                            unitriangular=True)
        out = torch.linalg.solve_triangular(upper, out, upper=True).T
        logdet = -torch.log(self.upper_diag()).sum().expand(x.shape[0])
        return out, logdet


class ResidualBlock(nn.Module):
    """Pre-activation block: bn -> relu -> linear -> bn -> relu -> linear,
    added; without batch norm relu -> linear -> relu -> linear."""

    def __init__(self, features: int, use_batch_norm: bool = True):
        super().__init__()
        if use_batch_norm:  # FrozenBatchNorm2d normalizes (N, C) as well
            self.batch_norm_layers = nn.ModuleList(
                [FrozenBatchNorm2d(features, eps=BN_EPS) for _ in range(2)])
        self.linear_layers = nn.ModuleList([nn.Linear(features, features) for _ in range(2)])

    def forward(self, x):
        t = x
        norms = getattr(self, "batch_norm_layers", (nn.Identity(), nn.Identity()))
        for bn, linear in zip(norms, self.linear_layers):
            t = linear(F.relu(bn(t)))
        return x + t


class ResidualNet(nn.Module):
    """The coupling's shift net; the context joins at the input layer."""

    def __init__(self, in_features: int, out_features: int, cfg: GlowConfig):
        super().__init__()
        h = cfg.hidden_features
        self.initial_layer = nn.Linear(in_features + (cfg.context_features or 0), h)
        self.blocks = nn.ModuleList([ResidualBlock(h, cfg.use_batch_norm)
                                     for _ in range(cfg.num_blocks_per_layer)])
        self.final_layer = nn.Linear(h, out_features)

    def forward(self, x, context=None):
        h = self.initial_layer(x if context is None else torch.cat([x, context], dim=1))
        for block in self.blocks:
            h = block(h)
        return self.final_layer(h)


class AdditiveCoupling(nn.Module):
    """Features with mask <= 0 pass as they are and feed the net; the others
    move by its output. logabsdet = 0."""

    def __init__(self, mask: np.ndarray, cfg: GlowConfig):
        super().__init__()
        identity = np.where(mask <= 0)[0]
        transform = np.where(mask > 0)[0]
        self.register_buffer("identity_idx", torch.as_tensor(identity), persistent=False)
        self.register_buffer("transform_idx", torch.as_tensor(transform), persistent=False)
        self.transform_net = ResidualNet(len(identity), len(transform), cfg)

    def _shift(self, x, context, sign: float):
        shift = self.transform_net(x[:, self.identity_idx], context)
        out = x.clone()
        out[:, self.transform_idx] = x[:, self.transform_idx] + sign * shift
        return out, x.new_zeros(x.shape[0])

    def forward(self, x, context=None):
        return self._shift(x, context, 1.0)

    def inverse(self, x, context=None):
        return self._shift(x, context, -1.0)


class CompositeTransform(nn.Module):
    def __init__(self, transforms):
        super().__init__()
        self._transforms = nn.ModuleList(transforms)


def _standard_normal_logprob(z: torch.Tensor) -> torch.Tensor:
    return -0.5 * (z * z).sum(-1) - 0.5 * z.shape[-1] * math.log(2 * math.pi)


class ConditionalGlow(nn.Module):
    def __init__(self, cfg: GlowConfig):
        super().__init__()
        self.cfg = cfg
        transforms = []
        for mask in cfg.masks():
            transforms += [ActNorm(cfg.features), LULinear(cfg.features),
                           AdditiveCoupling(mask, cfg)]
        self._transform = CompositeTransform(transforms)

    def _layers(self):
        t = self._transform._transforms
        return [(t[3 * i], t[3 * i + 1], t[3 * i + 2]) for i in range(self.cfg.num_layers)]

    def forward(self, inputs, context=None):
        """data -> noise and the total logabsdet (`glow_forward`)."""
        x, total = inputs, inputs.new_zeros(inputs.shape[0])
        for actnorm, lu, coupling in self._layers():
            for step in (actnorm, lu):
                x, ld = step(x)
                total = total + ld
            x, ld = coupling(x, context)
            total = total + ld
        return x, total

    def inverse(self, noise, context=None):
        """noise -> data and the inverse pass's logabsdet (`glow_inverse`)."""
        x, total = noise, noise.new_zeros(noise.shape[0])
        for actnorm, lu, coupling in reversed(self._layers()):
            x, ld = coupling.inverse(x, context)
            total = total + ld
            for step in (lu, actnorm):
                x, ld = step.inverse(x)
                total = total + ld
        return x, total

    def log_prob(self, inputs, context=None):
        """(log_prob, noise) of data rows (`glow_log_prob`)."""
        noise, logabsdet = self.forward(inputs, context)
        return _standard_normal_logprob(noise) + logabsdet, noise

    @torch.no_grad()
    def initialize_actnorm(self, inputs: torch.Tensor, context: Optional[torch.Tensor] = None):
        """The data-dependent ActNorm start (`seeme_tpu/flows/glow.py:304-323`),
        in place: per layer, from the rows reaching it, log_scale = -log(std)
        and shift = -mean(x / std), std = max(std(x, unbiased), 1e-3)."""
        x = inputs
        for actnorm, lu, coupling in self._layers():
            std = torch.clamp(x.std(dim=0, unbiased=True), min=1e-3)
            actnorm.log_scale.copy_(-torch.log(std))
            actnorm.shift.copy_(-(x / std).mean(dim=0))
            x = lu(actnorm(x)[0])[0]
            x = coupling(x, context)[0]

    def sample_and_log_prob(self, num_samples: int, context: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            noise: Optional[torch.Tensor] = None):
        """`glow_sample_and_log_prob`: base noise (B, num_samples, D), drawn
        from `generator` unless given, through the inverse with each context
        row repeated num_samples times; returns (samples, log_prob, noise)
        flat over (B * num_samples)."""
        B, D = context.shape[0], self.cfg.features
        if noise is None:
            noise = torch.randn(B, num_samples, D, generator=generator, device=context.device)
        noise_flat = noise.reshape(B * num_samples, D)
        ctx = context.repeat_interleave(num_samples, dim=0)
        samples, logabsdet = self.inverse(noise_flat, ctx)
        return samples, _standard_normal_logprob(noise_flat) - logabsdet, noise_flat
