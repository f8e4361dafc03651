"""Ego evaluation metrics (`seeme_tpu/eval/metrics.py:38-110`).

Per-sequence MPJPE, root error, head-orientation error and acceleration
error, with the reference's start alignment (head joint at frame 0) and
per-frame pelvis alignment, and the test-split filter that keeps a sequence
only when head_err < 0.9, root_err < 300 and accl > 0 (`compute.py:489-517`).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.rotations import quat_to_rotmat

HEAD_JOINT = 15
PELVIS = 0


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, dim) -> torch.Tensor:
    mask = mask.to(x.dtype)
    return (x * mask).sum(dim) / mask.sum(dim).clamp_min(1.0)


def ego_sequence_metrics(jts_pred: torch.Tensor, jts_gt: torch.Tensor,
                         quat_pred: torch.Tensor, quat_gt: torch.Tensor,
                         mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(B, T, 24, 3) joints, (B, T, 4) wxyz orientations, (B, T) valid-frame
    mask -> per-sequence values, each (B,)."""
    jts_gt = jts_gt - jts_gt[:, 0:1, HEAD_JOINT:HEAD_JOINT + 1]
    jts_pred = jts_pred - jts_pred[:, 0:1, HEAD_JOINT:HEAD_JOINT + 1]
    pelvis_gt = jts_gt[:, :, PELVIS]
    pelvis_pred = jts_pred[:, :, PELVIS]
    jts_gt_a = jts_gt - jts_gt[:, :, PELVIS:PELVIS + 1]
    jts_pred_a = jts_pred - jts_pred[:, :, PELVIS:PELVIS + 1]

    err = torch.linalg.norm(jts_pred_a - jts_gt_a, dim=-1)
    mpjpe = _masked_mean(err.mean(-1), mask, 1) * 1000.0
    root_err = _masked_mean(torch.linalg.norm(pelvis_gt - pelvis_pred, dim=-1), mask, 1) * 1000.0

    R_gt = quat_to_rotmat(quat_gt)
    R_pred = quat_to_rotmat(quat_pred)
    eye = torch.eye(3, dtype=R_gt.dtype, device=R_gt.device)
    frob = torch.linalg.norm(eye - torch.einsum("btij,btkj->btik", R_gt, R_pred), dim=(-2, -1))
    head_err = _masked_mean(frob, mask, 1)

    accel_gt = jts_gt[:, :-2] - 2 * jts_gt[:, 1:-1] + jts_gt[:, 2:]
    accel_pred = jts_pred[:, :-2] - 2 * jts_pred[:, 1:-1] + jts_pred[:, 2:]
    accel_normed = torch.linalg.norm(accel_pred - accel_gt, dim=-1).mean(-1)
    accel_mask = mask[:, :-2] & mask[:, 1:-1] & mask[:, 2:]
    accl = _masked_mean(accel_normed, accel_mask, 1) * 1000.0
    return {"mpjpe": mpjpe, "root_err": root_err, "head_err": head_err, "accl": accl}


def kept_by_test_split(per_seq: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B,) bool: the sequences the reference's test split counts."""
    return ((per_seq["head_err"] < 0.9) & (per_seq["root_err"] < 300.0)
            & (per_seq["accl"] > 0.0))


def filtered_means(per_seq: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """MPJPE / ROOT_ERROR / HEAD_ORIENTATION_ERROR / ACCL means over the kept
    sequences (the `EgoMetric` test-split accumulation for one batch), and
    how many were kept."""
    keep = kept_by_test_split(per_seq)
    n = int(keep.sum())
    names = {"mpjpe": "MPJPE", "root_err": "ROOT_ERROR",
             "head_err": "HEAD_ORIENTATION_ERROR", "accl": "ACCL"}
    out = {names[k]: (float(v[keep].mean()) if n else float("nan")) for k, v in per_seq.items()}
    out["kept"] = n
    return out
