"""PointNet scene encoder with FC-ResNet blocks (`seeme_tpu/nn/pointnet.py`).

The parameters keep the reference layout: blocks 1-3 hold ONE `fc_0` and
one `shortcut` over the concatenation [x; pooled] (`respointnet.py:38-46`).
The forward uses the split algebra instead, Linear([x; p]) = x W_x + p W_p,
so the per-point (B, N, 2h) concatenation is never built. This module is the
plain version of the fused kernels in `ops/pointnet_fused.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ResnetBlockFC(nn.Module):
    """relu -> fc_0 -> relu -> fc_1 (zero-init) residual, bias-free shortcut."""

    def __init__(self, size_in: int, size_out: int, size_h: int):
        super().__init__()
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        self.shortcut = nn.Linear(size_in, size_out, bias=False)


def split_block_weights(block: ResnetBlockFC, h: int):
    """(w0x, w0p, b0, w1, b1, wsx, wsp) of a block over [x; pooled], each
    weight as (in, out): the split algebra's operands."""
    w0 = block.fc_0.weight.t()
    ws = block.shortcut.weight.t()
    return (w0[:h], w0[h:], block.fc_0.bias, block.fc_1.weight.t(),
            block.fc_1.bias, ws[:h], ws[h:])


class ResnetPointnet(nn.Module):
    def __init__(self, out_dim: int = 512, hidden_dim: int = 512):
        super().__init__()
        h = hidden_dim
        self.hidden_dim = h
        self.fc_pos_0 = nn.Linear(3, 2 * h)
        self.block_0 = ResnetBlockFC(2 * h, h, h)
        self.block_1 = ResnetBlockFC(2 * h, h, h)
        self.block_2 = ResnetBlockFC(2 * h, h, h)
        self.block_3 = ResnetBlockFC(2 * h, h, h)
        self.fc_c = nn.Linear(h, out_dim)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) point cloud -> (B, out_dim) embedding."""
        h = self.fc_pos_0(points)
        b0 = self.block_0
        net = b0.fc_0(F.relu(h))
        x = b0.shortcut(h) + b0.fc_1(F.relu(net))
        for block in (self.block_1, self.block_2, self.block_3):
            w0x, w0p, b0_, w1, b1, wsx, wsp = split_block_weights(block, self.hidden_dim)
            pooled = x.amax(dim=1, keepdim=True)
            net = F.relu(x) @ w0x + F.relu(pooled) @ w0p + b0_
            x = x @ wsx + pooled @ wsp + F.relu(net) @ w1 + b1
        return self.fc_c(F.relu(x.amax(dim=1)))
