"""Motion-reconstruction metrics of the text-to-motion evaluation
(`seeme_tpu/eval/t2m_metrics.py:154-200`).

MPJPE (root-aligned), PA-MPJPE (per-frame similarity alignment) and ACCEL
over each sequence's valid frames, in millimetres, averaged over sequences.
A host-side accumulator in numpy, as in the JAX package; the TM2T metrics
wait for the evaluator weights.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np


def procrustes_align(S1: np.ndarray, S2: np.ndarray) -> np.ndarray:
    """Similarity transform of S1 (N, 3) onto S2 — the PA of PA-MPJPE."""
    mu1, mu2 = S1.mean(0), S2.mean(0)
    X1, X2 = S1 - mu1, S2 - mu2
    var1 = (X1**2).sum()
    K = X1.T @ X2
    U, _, Vh = np.linalg.svd(K)
    Z = np.eye(3)
    Z[-1, -1] = np.sign(np.linalg.det(U @ Vh))
    R = Vh.T @ Z @ U.T
    scale = np.trace(R @ K) / var1
    t = mu2 - scale * R @ mu1
    return scale * S1 @ R.T + t


@dataclass
class MRMetrics:
    force_in_meter: bool = True
    sums: Dict[str, float] = field(default_factory=dict)
    count: int = 0

    def update(self, joints_pred, joints_gt, lengths) -> None:
        """(B, T, J, 3) predicted and reference joints, (B,) valid lengths."""
        factor = 1000.0 if self.force_in_meter else 1.0
        for b in range(len(joints_pred)):
            L = int(lengths[b])
            p, g = np.asarray(joints_pred[b][:L]), np.asarray(joints_gt[b][:L])
            mpjpe = np.linalg.norm((p - p[:, :1]) - (g - g[:, :1]), axis=-1).mean() * factor
            pa = np.stack([procrustes_align(p[t], g[t]) for t in range(L)])
            pampjpe = np.linalg.norm(pa - g, axis=-1).mean() * factor
            self.sums["MPJPE"] = self.sums.get("MPJPE", 0.0) + mpjpe
            self.sums["PAMPJPE"] = self.sums.get("PAMPJPE", 0.0) + pampjpe
            if L > 2:
                accel_p = p[:-2] - 2 * p[1:-1] + p[2:]
                accel_g = g[:-2] - 2 * g[1:-1] + g[2:]
                accel = np.linalg.norm(accel_p - accel_g, axis=-1).mean() * factor
                self.sums["ACCEL"] = self.sums.get("ACCEL", 0.0) + accel
            self.count += 1

    def compute(self) -> Dict[str, float]:
        return {k: v / max(self.count, 1) for k, v in self.sums.items()}
