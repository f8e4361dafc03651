"""The UESTC action-recognition evaluator (`seeme_tpu/eval/stgcn.py`, the
reference's ST-GCN, `mld/models/architectures/uestc_stgcn.py:8-411`, with 6
rot6d channels a joint, the SMPL graph and the spatial partition).

Activations are torch's (N, C, T, V) and every convolution is an
`nn.Conv2d` (cuDNN on the card); the input is (N, T, V, C) as in the JAX
package. `data_bn` normalises the per-frame (V * C) vector, v-major. Ten
blocks (`_BLOCKS`): a graph convolution (a 1x1 convolution to K * C'
channels contracted with the (K, V, V) partition adjacency times the
block's learned `edge_importance`), batch norm, ReLU, a (9, 1) temporal
convolution with the block's stride, batch norm, the residual (none in
block 0, identity when the shape is kept, else a strided 1x1 convolution
and batch norm), ReLU. The two stride-2 blocks take T to ceil(T / 4).
Features are the block-10 activations averaged over frames and joints;
with `lengths`, only over the first ceil(length * t_out / T) frames. The
classifier `fcn` is the reference's 1x1 convolution over the pooled
features.

Batch norm uses its running statistics with eps 1e-5
(`nn/resnet.py::FrozenBatchNorm2d`): the evaluator is always frozen. The
keys are the reference's (`data_bn`, `st_gcn_networks.{i}.gcn.conv`,
`.tcn.0` / `.tcn.2` / `.tcn.3`, `.residual.0` / `.residual.1`,
`edge_importance.{i}`, `fcn`), so the released `uestc_rot6d_stgcn.tar`
loads as it is (its `A` buffer is the adjacency this module builds); the
inverse of `tools/convert_checkpoint.py::convert_uestc_stgcn`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.smpl import NUM_JOINTS, PARENTS
from ..nn.resnet import FrozenBatchNorm2d

__all__ = ["STGCN", "smpl_spatial_adjacency"]

# (out_channels, temporal stride) of the 10 blocks (`uestc_stgcn.py:48-59`)
_BLOCKS = ((64, 1), (64, 1), (64, 1), (64, 1), (128, 2),
           (128, 1), (128, 1), (256, 2), (256, 1), (256, 1))
TEMPORAL_KERNEL = 9


def _normalize_digraph(a: np.ndarray) -> np.ndarray:
    deg = a.sum(0)
    dn = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-12), 0.0)
    return a * dn[None, :]


def smpl_spatial_adjacency() -> np.ndarray:
    """(K=3, 24, 24) spatial-partition adjacency of the SMPL tree
    (`uestc_stgcn.py:309-352`: strategy 'spatial', max_hop 1, the pelvis
    the center). The reference's quirk is kept: a node's distance to the
    center is read off the same max_hop=1 hop matrix, so it is 0 (pelvis),
    1 (its children) or inf (every other joint); two adjacent deep joints
    compare inf == inf and land in the 'root' partition."""
    V = NUM_JOINTS
    adj = np.eye(V)
    for j in range(1, V):
        p = int(PARENTS[j])
        adj[j, p] = adj[p, j] = 1.0
    hop = np.where(np.eye(V, dtype=bool), 0.0, np.where(adj > 0, 1.0, np.inf))
    norm = _normalize_digraph((hop <= 1).astype(np.float64))
    to_center = hop[:, 0]
    parts = []
    for h in (0, 1):
        a_root, a_close, a_further = np.zeros((V, V)), np.zeros((V, V)), np.zeros((V, V))
        for i in range(V):
            for j in range(V):
                if hop[j, i] != h:
                    continue
                if to_center[j] == to_center[i]:
                    a_root[j, i] = norm[j, i]
                elif to_center[j] > to_center[i]:
                    a_close[j, i] = norm[j, i]
                else:
                    a_further[j, i] = norm[j, i]
        parts.extend([a_root] if h == 0 else [a_root + a_close, a_further])
    return np.stack(parts).astype(np.float32)


class _GraphConv(nn.Module):
    """ConvTemporalGraphical (`uestc_stgcn.py:354-411`)."""

    def __init__(self, in_channels: int, out_channels: int, K: int):
        super().__init__()
        self.K = K
        self.conv = nn.Conv2d(in_channels, out_channels * K, 1)

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        N, KC, T, V = y.shape
        return torch.einsum("nkctv,kvw->nctw", y.view(N, self.K, KC // self.K, T, V), A)


class _StGcnBlock(nn.Module):
    """st_gcn (`uestc_stgcn.py:135-210`), without its dropout (p = 0)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, residual: bool, K: int):
        super().__init__()
        self.gcn = _GraphConv(in_channels, out_channels, K)
        self.tcn = nn.Sequential(
            FrozenBatchNorm2d(out_channels), nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, (TEMPORAL_KERNEL, 1), (stride, 1),
                      ((TEMPORAL_KERNEL - 1) // 2, 0)),
            FrozenBatchNorm2d(out_channels))
        self.identity = residual and in_channels == out_channels and stride == 1
        self.residual = None
        if residual and not self.identity:
            self.residual = nn.Sequential(nn.Conv2d(in_channels, out_channels, 1, (stride, 1)),
                                          FrozenBatchNorm2d(out_channels))

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        y = self.tcn(self.gcn(x, A))
        if self.identity:
            y = y + x
        elif self.residual is not None:
            y = y + self.residual(x)
        return torch.relu(y)


class STGCN(nn.Module):
    def __init__(self, num_class: int = 40, in_channels: int = 6):
        super().__init__()
        A = torch.as_tensor(smpl_spatial_adjacency())
        self.register_buffer("A", A, persistent=False)
        K, V, _ = A.shape
        self.data_bn = FrozenBatchNorm2d(in_channels * V)
        blocks, c = [], in_channels
        for i, (out, stride) in enumerate(_BLOCKS):
            blocks.append(_StGcnBlock(c, out, stride, residual=i > 0, K=K))
            c = out
        self.st_gcn_networks = nn.ModuleList(blocks)
        self.edge_importance = nn.ParameterList([nn.Parameter(torch.ones(K, V, V))
                                                 for _ in _BLOCKS])
        self.fcn = nn.Conv2d(c, num_class, 1)

    def forward(self, motion: torch.Tensor, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """motion (N, T, V=24, C=6) rot6d, lengths (N,) optional ->
        (logits (N, num_class), features (N, 256))."""
        N, T, V, C = motion.shape
        x = self.data_bn(motion.reshape(N, T, V * C).transpose(1, 2))       # (N, V*C, T)
        x = x.view(N, V, C, T).permute(0, 2, 3, 1)                           # (N, C, T, V)
        for block, importance in zip(self.st_gcn_networks, self.edge_importance):
            x = block(x, self.A * importance)
        if lengths is None:
            feats = x.mean(dim=(2, 3))
        else:
            t_out = x.shape[2]
            n_valid = torch.ceil(lengths.to(x.device, x.dtype)[:, None] * (t_out / T))
            w = (torch.arange(t_out, device=x.device)[None] < n_valid).to(x.dtype)  # (N, t_out)
            feats = (x * w[:, None, :, None]).sum(dim=(2, 3)) / (
                w.sum(dim=1, keepdim=True) * x.shape[3]).clamp_min(1e-6)
        logits = self.fcn(feats[:, :, None, None])[:, :, 0, 0]
        return logits, feats
