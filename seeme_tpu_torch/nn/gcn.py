"""Modulated graph convolution over the SMPL 24-joint skeleton
(`seeme_tpu/nn/gcn.py`), with the reference's module names
(`diffusion_model.gconv_input.0.*`, `gconv_layers.{i}.gconv{1,2}.*`,
`gconv_output.*`, as `tools/convert_checkpoint.py::convert_egohmr` reads
them). Batch norm runs with running statistics, in training too, as the
JAX package applies the GCN with `train=False` everywhere; the statistics
train by gradient (`nn/resnet.py::FrozenBatchNorm2d`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.smpl import PARENTS
from .resnet import FrozenBatchNorm2d


def smpl_adjacency() -> np.ndarray:
    """24 x 24 adjacency of the kinematic tree, symmetrized, row-normalized
    without self-loops, then the identity put back (`seeme_tpu/nn/gcn.py:21`)."""
    A = np.zeros((24, 24), np.float32)
    for child in range(1, 24):
        A[PARENTS[child], child] = 1.0
    A = np.maximum(A, A.T)
    rowsum = A.sum(1)
    r_inv = np.where(rowsum > 0, 1.0 / np.maximum(rowsum, 1e-12), 0.0)
    A = A * r_inv[:, None]
    eye = np.eye(24, dtype=np.float32)
    return A * (1 - eye) + eye


class ModulatedGraphConv(nn.Module):
    """Self and neighbour weight branches W (2, in, out), per-joint
    modulation M (J, out), learned adjacency offset adj2 (J, J), bias."""

    def __init__(self, in_features: int, out_features: int, adj: np.ndarray):
        super().__init__()
        J = adj.shape[0]
        self.W = nn.Parameter(torch.zeros(2, in_features, out_features))
        self.M = nn.Parameter(torch.zeros(J, out_features))
        self.adj2 = nn.Parameter(torch.full((J, J), 1e-6))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.register_buffer("adj", torch.as_tensor(adj, dtype=torch.float32), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, J, in) -> (B, J, out)
        h0, h1 = x @ self.W[0], x @ self.W[1]
        adj = self.adj + self.adj2
        adj = (adj.T + adj) / 2
        eye = torch.eye(adj.shape[0], device=adj.device)
        out = (adj * eye) @ (self.M * h0) + (adj * (1 - eye)) @ (self.M * h1)
        return out + self.bias


class GraphConvBlock(nn.Module):
    """gconv -> batch norm over the channels -> relu."""

    def __init__(self, in_features: int, out_features: int, adj: np.ndarray):
        super().__init__()
        self.gconv = ModulatedGraphConv(in_features, out_features, adj)
        self.bn = FrozenBatchNorm2d(out_features)  # normalizes (N, C) as well

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.gconv(x)
        return torch.relu(self.bn(h.reshape(-1, h.shape[-1])).reshape(h.shape))


class ResGraphConv(nn.Module):
    def __init__(self, hid: int, adj: np.ndarray):
        super().__init__()
        self.gconv1 = GraphConvBlock(hid, hid, adj)
        self.gconv2 = GraphConvBlock(hid, hid, adj)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.gconv2(self.gconv1(x))


class ModulatedGCN(nn.Module):
    """Input block, `num_layers` residual blocks, output gconv (the
    reference's non-local layer off, as shipped)."""

    def __init__(self, in_dim: int, adj: np.ndarray, hid_dim: int = 1024, out_dim: int = 6,
                 num_layers: int = 4):
        super().__init__()
        self.gconv_input = nn.ModuleList([GraphConvBlock(in_dim, hid_dim, adj)])
        self.gconv_layers = nn.ModuleList([ResGraphConv(hid_dim, adj) for _ in range(num_layers)])
        self.gconv_output = ModulatedGraphConv(hid_dim, out_dim, adj)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.gconv_input[0](x)
        for layer in self.gconv_layers:
            x = layer(x)
        return self.gconv_output(x)
