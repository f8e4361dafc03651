"""Body-scene penetration loss (`seeme_tpu/core/collision.py`).

The reference's COAP occupancy term (`EgoHMR/models/egohmr/egohmr.py:414-443`)
as the JAX package writes it: one capsule per SMPL bone, and the mean
squared penetration of the scene points inside the body's padded bounding
box:

    penetration(p) = max_k relu(r_k - dist(p, segment_k))
    loss = mean_b sum_p w(p) penetration(p)^2 / (sum_p w(p) + 1e-6)
"""

from __future__ import annotations

import numpy as np
import torch

from .smpl import PARENTS

# capsule radii in metres, by the child joint 1..23 of each bone
DEFAULT_BONE_RADII = np.array([
    0.11, 0.11, 0.09, 0.07, 0.07, 0.09, 0.05, 0.05, 0.09, 0.04, 0.04, 0.06,
    0.08, 0.08, 0.06, 0.05, 0.05, 0.04, 0.04, 0.035, 0.035, 0.03, 0.03,
], dtype=np.float32)


def point_segment_distance(points: torch.Tensor, a: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) points against (..., K, 3) segments a -> b: (..., N, K)."""
    ab = b - a
    ap = points[..., :, None, :] - a[..., None, :, :]
    denom = (ab * ab).sum(-1)[..., None, :] + 1e-9
    t = torch.clamp((ap * ab[..., None, :, :]).sum(-1) / denom, 0.0, 1.0)
    closest = a[..., None, :, :] + t[..., None] * ab[..., None, :, :]
    return torch.linalg.norm(points[..., :, None, :] - closest, dim=-1)


def scene_collision_loss(scene_points: torch.Tensor, joints24: torch.Tensor,
                         bone_radii=None, bbox_pad: float = 0.05) -> torch.Tensor:
    """(B, N, 3) scene points and (B, 24, 3) joints in one frame -> the
    scalar penetration loss."""
    radii = torch.as_tensor(DEFAULT_BONE_RADII if bone_radii is None else bone_radii,
                            dtype=joints24.dtype, device=joints24.device)
    parent = torch.as_tensor(PARENTS[1:24], device=joints24.device)
    dist = point_segment_distance(scene_points, joints24[:, parent], joints24[:, 1:24])
    penetration = torch.relu(radii - dist).amax(dim=-1)
    lo = joints24.amin(dim=1, keepdim=True) - bbox_pad
    hi = joints24.amax(dim=1, keepdim=True) + bbox_pad
    w = ((scene_points >= lo) & (scene_points <= hi)).all(dim=-1).to(penetration.dtype)
    return ((w * penetration ** 2).sum(1) / (w.sum(1) + 1e-6)).mean()
