"""rot6d action-motion features -> SMPL joint positions
(`seeme_tpu/core/rotation2xyz.py`, the reference's Rotation2xyz,
`mld/models/operator/rotation2xyz.py:14-119`, on its rot6d path).

The 150 features of a frame are 24 joints of diffusion-layout rot6d (the
first two matrix columns, 144 numbers), the root trajectory (144:147) and
three zeros (`seeme_tpu/data/a2m.py:40-51`). Forward kinematics runs
through `smpl_joints24` with `betas` (..., n_betas), one shape a sequence,
or zero betas (the 24 skeleton joints, no skinning); the joints are rooted
at the pelvis, then the trajectory is added when `translation` is set and
the features carry it (F >= 147). `keep_global_orient=False` replaces the
root rotation by the identity.
"""

from __future__ import annotations

from typing import Optional

import torch

from .rotations import rot6d_to_rotmat
from .smpl import NUM_JOINTS, SmplModel, smpl_joints24

__all__ = ["rot6d_motion_to_joints"]

POSE_FEATS = NUM_JOINTS * 6  # 144 rot6d numbers a frame


def rot6d_motion_to_joints(smpl: SmplModel, feats: torch.Tensor, translation: bool = True,
                           keep_global_orient: bool = True,
                           betas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """feats (..., T, F) and betas (..., n_betas), each sequence's shape
    over its T frames (`seeme_tpu/core/rotation2xyz.py:52-53`) -> joints
    (..., T, 24, 3)."""
    lead = feats.shape[:-1]
    rotmats = rot6d_to_rotmat(feats[..., :POSE_FEATS].reshape(*lead, NUM_JOINTS, 6),
                              mode="diffusion")
    if not keep_global_orient:
        eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
        rotmats = torch.cat([eye.expand(*lead, 1, 3, 3), rotmats[..., 1:, :, :]], dim=-3)
    flat = rotmats.reshape(-1, NUM_JOINTS, 3, 3)
    if betas is None:
        betas = flat.new_zeros(flat.shape[0], smpl.shapedirs.shape[-1])
    else:
        betas = betas[..., None, :].expand(*lead, betas.shape[-1]).reshape(flat.shape[0], -1)
    joints = smpl_joints24(smpl, betas, flat[:, 1:], flat[:, :1], pose2rot=False)
    joints = joints.reshape(*lead, NUM_JOINTS, 3)
    joints = joints - joints[..., :1, :]
    if translation and feats.shape[-1] >= POSE_FEATS + 3:
        joints = joints + feats[..., None, POSE_FEATS:POSE_FEATS + 3]
    return joints
