"""Per-image mesh-recovery metrics of the ProHMR-Scene and EgoHMR evaluation
CLIs (`test_prohmr_scene.py`, `test_egohmr.py` at the repo root), numpy on
the host, in millimetres: pelvis-aligned MPJPE, PA-MPJPE, pelvis-aligned
V2V, and with a visibility mask MPJPE over the visible and the invisible
joints; each a mean over samples.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .t2m_metrics import procrustes_align


class HmrMetrics:
    def __init__(self):
        self.values: Dict[str, List[float]] = {
            k: [] for k in ("MPJPE", "PA-MPJPE", "V2V", "MPJPE-vis", "MPJPE-invis")}

    def update(self, pred_j: np.ndarray, pred_v: np.ndarray, gt_j: np.ndarray,
               gt_v: np.ndarray, vis: Optional[np.ndarray] = None) -> None:
        """(B, 24, 3) joints, (B, V, 3) vertices, (B, 24) joint visibility."""
        err = np.linalg.norm((pred_j - pred_j[:, :1]) - (gt_j - gt_j[:, :1]), axis=-1) * 1000
        self.values["MPJPE"].extend(err.mean(-1))
        for b in range(len(pred_j)):
            pa = procrustes_align(pred_j[b], gt_j[b])
            self.values["PA-MPJPE"].append(np.linalg.norm(pa - gt_j[b], axis=-1).mean() * 1000)
            if vis is not None:
                if vis[b].any():
                    self.values["MPJPE-vis"].append(err[b][vis[b]].mean())
                if (~vis[b]).any():
                    self.values["MPJPE-invis"].append(err[b][~vis[b]].mean())
        v2v = np.linalg.norm((pred_v - pred_j[:, :1]) - (gt_v - gt_j[:, :1]), axis=-1)
        self.values["V2V"].extend(v2v.mean(-1) * 1000)

    def compute(self) -> Dict[str, float]:
        return {k: float(np.mean(v)) for k, v in self.values.items() if v}
