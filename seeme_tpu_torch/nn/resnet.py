"""ResNet-50 image backbone (`seeme_tpu/nn/resnet.py`), NHWC in, 2048-d out.

conv 7x7/2, batch norm, ReLU, max-pool 3x3/2, four bottleneck stages
[3, 4, 6, 3] with the stride on each stage's first 3x3 convolution, global
average pool. The module tree and its state-dict keys are torchvision's
(`conv1`, `bn1`, `layer{s}.{b}.conv{c}` / `bn{c}`, `layer{s}.{b}.downsample.0/1`),
so `tools/convert_checkpoint.py::convert_resnet50` reads a port state dict
name for name, and an ImageNet checkpoint in that layout loads as it is.
There is no `fc`: the JAX package's backbone ends at the pool.

The backbone is frozen wherever SEE-ME uses it, and the JAX package runs it
with `train=False` everywhere: batch norm always uses its running statistics
(eps 1e-5), which the perception stack's training CLIs train by gradient. The convolutions are `nn.Conv2d`; the JAX package runs them outside
any Pallas kernel too.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


class FrozenBatchNorm2d(nn.Module):
    """Batch norm with running statistics only: y = (x - mean) * (weight /
    sqrt(var + eps)) + bias over dimension 1. Keys `weight`, `bias`,
    `running_mean`, `running_var`; a checkpoint's `num_batches_tracked` is
    ignored.

    The statistics are parameters, as in the JAX package, whose training
    CLIs differentiate and update them with the rest of the tree
    (`seeme_tpu/nn/resnet.py` and `nn/gcn.py` keep them in `batch_stats`, the
    glow in its parameters). When a statistic requires grad under grad mode
    the normalisation is written out, since `F.batch_norm` has no derivative
    for them; otherwise it is `F.batch_norm`. Modules that must not train
    are frozen (`requires_grad_(False)`) and left out of the optimizer."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.running_mean = nn.Parameter(torch.zeros(num_features))
        self.running_var = nn.Parameter(torch.ones(num_features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and (self.running_mean.requires_grad
                                        or self.running_var.requires_grad):
            shape = (1, -1) + (1,) * (x.ndim - 2)
            scale = self.weight * torch.rsqrt(self.running_var + self.eps)
            return (x - self.running_mean.view(shape)) * scale.view(shape) + self.bias.view(shape)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out)
        self.downsample = (nn.Sequential(nn.Conv2d(in_planes, out, 1, stride=stride, bias=False),
                                         FrozenBatchNorm2d(out)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNet(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        in_planes, planes = 64, 64
        for stage, blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            seq = []
            for b in range(blocks):
                seq.append(Bottleneck(in_planes, planes, stride if b == 0 else 1, downsample=b == 0))
                in_planes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*seq))
            planes *= 2
        self.num_stages = len(layers)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) image -> (B, 2048) pooled features. Max-pool padding
        acts as -inf, as `flax.linen.max_pool`'s does."""
        x = F.relu(self.bn1(self.conv1(image.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean(dim=(2, 3))


def resnet50() -> ResNet:
    return ResNet((3, 4, 6, 3))
