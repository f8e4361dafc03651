"""APE / AVE metrics (`seeme_tpu/eval/ape_ave.py`, the TEMOS family of
`mld/models/metrics/compute.py` APE_root/traj/pose/joints and AVE_*,
:124-232, 520-543).

APE: summed L2 position error per frame (root, XZ trajectory, local pose,
global joints), over the total frame count. AVE: the error of the same
quantities' variances over the valid frames, per sequence. The local pose
comes from the Rifke decomposition (`core/rifke.py`), computed on the
joints' device; the sums accumulate on the host in float64, as the JAX
class's numpy sums do.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from ..core.rifke import joints_to_rifke, rifke_extract


def _variance(x: np.ndarray, length: int, axis: int = 0) -> np.ndarray:
    """`metrics/utils.py` variance: mean squared deviation over the valid frames."""
    x = x[:length]
    return ((x - x.mean(axis=axis, keepdims=True)) ** 2).mean(axis=axis)


def _decompose(joints: torch.Tensor):
    """(T, 22, 3) -> numpy (root (T, 3), traj (T, 2), poses (T, 21, 3))."""
    _, poses_features, _, _ = rifke_extract(joints_to_rifke(joints))
    j = joints.cpu().numpy()
    return j[:, 0, :], j[:, 0, [0, 2]], poses_features.reshape(len(joints), -1, 3).cpu().numpy()


@dataclass
class ApeAveMetrics:
    """Accumulates APE (per frame) and AVE (per sequence) sums."""

    sums: Dict[str, float] = field(default_factory=dict)
    count_frames: int = 0
    count_seq: int = 0

    def _add(self, key, value):
        self.sums[key] = self.sums.get(key, 0.0) + float(np.sum(value))

    def update(self, joints_pred, joints_gt, lengths) -> None:
        """(B, T, 22, 3) predicted and reference joints (tensors on any
        device, or arrays) and (B,) lengths."""
        joints_pred, joints_gt = torch.as_tensor(joints_pred), torch.as_tensor(joints_gt)
        for b in range(len(joints_pred)):
            L = int(lengths[b])
            root_p, traj_p, poses_p = _decompose(joints_pred[b, :L])
            root_g, traj_g, poses_g = _decompose(joints_gt[b, :L])
            jp, jg = joints_pred[b, :L].cpu().numpy(), joints_gt[b, :L].cpu().numpy()

            self._add("APE_root", np.linalg.norm(root_p - root_g, axis=1))
            self._add("APE_traj", np.linalg.norm(traj_p - traj_g, axis=1))
            self._add("APE_pose", np.linalg.norm(poses_p - poses_g, axis=2).mean(1))
            self._add("APE_joints", np.linalg.norm(jp - jg, axis=2).mean(1))

            self._add("AVE_root", np.linalg.norm(_variance(root_p, L) - _variance(root_g, L)))
            self._add("AVE_traj", np.linalg.norm(_variance(traj_p, L) - _variance(traj_g, L)))
            self._add("AVE_pose", np.linalg.norm(
                _variance(poses_p, L) - _variance(poses_g, L), axis=1).mean())
            self._add("AVE_joints", np.linalg.norm(
                _variance(jp, L) - _variance(jg, L), axis=1).mean())

            self.count_frames += L
            self.count_seq += 1

    def compute(self) -> Dict[str, float]:
        return {k: v / max(self.count_frames if k.startswith("APE") else self.count_seq, 1)
                for k, v in self.sums.items()}
