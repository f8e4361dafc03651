"""Raw joints -> HumanML3D / KIT RIC features (`seeme_tpu/core/motion_process.py`,
numpy there), on torch tensors in float64 on the device of the input.

The reference's offline feature pipeline: `process_file` and
`uniform_skeleton` of `mld/data/humanml/scripts/motion_process.py:169-360`
turn raw (T, J, 3) joints into the 263-d (HumanML3D, J = 22) or 251-d (KIT,
J = 21) vectors stored as `new_joint_vecs`, with the skeleton's offsets,
inverse and forward kinematics (`mld/data/humanml/common/skeleton.py:4-150`),
the quaternion helpers (`common/quaternion.py`) and the skeleton constants
(`utils/paramUtil.py`). The inverse, features -> joints, is
`core/ric.py::recover_from_ric`.

Feature layout (`motion_process.py:330-348`):
  [root_rot_vel (1) | root_lin_vel_xz (2) | root_height (1) |
   ric ((J-1)*3) | rot6d ((J-1)*6) | local_vel (J*3) | feet_contacts (4)]

The smoothing of the facing direction (scipy's `gaussian_filter1d`, sigma
20, 'nearest' edges, truncated at 4 sigma) is a (T, T) matrix product here,
so it runs on the card too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from .ric import qinv, qmul, qrot

# `paramUtil.py:32-55` (t2m) and :1-30 (kit): unit offset directions per joint
T2M_RAW_OFFSETS = np.array([
    [0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, -1, 0],
    [0, 1, 0], [0, -1, 0], [0, -1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1],
    [0, 1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, -1, 0], [0, -1, 0],
    [0, -1, 0], [0, -1, 0], [0, -1, 0], [0, -1, 0],
], dtype=np.float64)

T2M_KINEMATIC_CHAIN = [
    [0, 2, 5, 8, 11], [0, 1, 4, 7, 10], [0, 3, 6, 9, 12, 15],
    [9, 14, 17, 19, 21], [9, 13, 16, 18, 20],
]

KIT_RAW_OFFSETS = np.array([
    [0, 0, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [1, 0, 0],
    [0, -1, 0], [0, -1, 0], [-1, 0, 0], [0, -1, 0], [0, -1, 0], [1, 0, 0],
    [0, -1, 0], [0, -1, 0], [0, 0, 1], [0, 0, 1], [-1, 0, 0], [0, -1, 0],
    [0, -1, 0], [0, 0, 1], [0, 0, 1],
], dtype=np.float64)

KIT_KINEMATIC_CHAIN = [
    [0, 11, 12, 13, 14, 15], [0, 16, 17, 18, 19, 20], [0, 1, 2, 3, 4],
    [3, 5, 6, 7], [3, 8, 9, 10],
]


@dataclass(frozen=True)
class SkeletonSpec:
    """Per-dataset constants (`motion_process.py:435-447, 481-494`)."""

    raw_offsets: np.ndarray
    chains: List[List[int]]
    face_joints: Sequence[int]    # r_hip, l_hip, sdr_r, sdr_l
    fid_l: Sequence[int]
    fid_r: Sequence[int]
    leg_idx: Sequence[int]        # lower-leg joints for the scale ratio
    joints_num: int
    feet_thre: float


HUMANML3D = SkeletonSpec(T2M_RAW_OFFSETS, T2M_KINEMATIC_CHAIN,
                         face_joints=(2, 1, 17, 16), fid_l=(7, 10),
                         fid_r=(8, 11), leg_idx=(5, 8), joints_num=22,
                         feet_thre=0.002)
KIT = SkeletonSpec(KIT_RAW_OFFSETS, KIT_KINEMATIC_CHAIN,
                   face_joints=(11, 16, 5, 8), fid_l=(19, 20),
                   fid_r=(14, 15), leg_idx=(17, 18), joints_num=21,
                   feet_thre=0.05)

SPECS = {"humanml3d": HUMANML3D, "t2m": HUMANML3D, "kit": KIT}


# ------------------------------------------------------ quaternions (w, x, y, z)

def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def qbetween(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """The quaternion rotating v0 onto v1 (`quaternion.py:387-397`)."""
    v = torch.linalg.cross(*torch.broadcast_tensors(v0, v1))
    w = torch.sqrt((v0 ** 2).sum(-1, keepdim=True) * (v1 ** 2).sum(-1, keepdim=True)) \
        + (v0 * v1).sum(-1, keepdim=True)
    return qnormalize(torch.cat([w.expand(v.shape[:-1] + (1,)), v], dim=-1))


def qfix(q: torch.Tensor) -> torch.Tensor:
    """Sign continuity along the time axis of (T, J, 4) quaternions
    (`quaternion.py:149-166`)."""
    if q.ndim != 3 or q.shape[-1] != 4:
        raise ValueError(f"qfix takes (T, J, 4) quaternions, got {tuple(q.shape)}")
    result = q.clone()
    dots = (q[1:] * q[:-1]).sum(dim=2)
    mask = (torch.cumsum((dots < 0).long(), dim=0) % 2).bool()
    tail = result[1:]
    tail[mask] *= -1
    return result


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = qnormalize(q).unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_to_cont6d(q: torch.Tensor) -> torch.Tensor:
    """The first two rotation-matrix columns (`quaternion.py:308-311`)."""
    m = quat_to_rotmat(q)
    return torch.cat([m[..., 0], m[..., 1]], dim=-1)


# --------------------------------------------------------------- skeleton

def _parents(chains: List[List[int]], n: int) -> List[int]:
    parents = [0] * n
    parents[0] = -1
    for chain in chains:
        for j in range(1, len(chain)):
            parents[chain[j]] = chain[j - 1]
    return parents


def _const(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), dtype=like.dtype, device=like.device)


def gaussian_smooth(x: torch.Tensor, sigma: float = 20.0, truncate: float = 4.0) -> torch.Tensor:
    """scipy's `gaussian_filter1d(x, sigma, axis=0, mode="nearest")` of a
    (T, C) tensor, as one (T, T) matrix product."""
    r = int(truncate * sigma + 0.5)
    taps = torch.arange(-r, r + 1, dtype=x.dtype, device=x.device)
    w = torch.exp(-0.5 / (sigma * sigma) * taps ** 2)
    w = w / w.sum()
    T = x.shape[0]
    rows = torch.arange(T, device=x.device)[:, None].expand(T, 2 * r + 1)
    cols = (rows + torch.arange(-r, r + 1, device=x.device)).clamp(0, T - 1)
    smooth = torch.zeros(T, T, dtype=x.dtype, device=x.device)
    smooth.scatter_add_(1, cols, w.expand(T, -1).contiguous())
    return smooth @ x


def get_offsets_joints(joints0: torch.Tensor, spec: SkeletonSpec) -> torch.Tensor:
    """Bone-length-scaled unit offsets from one rest frame (`skeleton.py:42-50`)."""
    parents = _parents(spec.chains, spec.joints_num)
    offsets = _const(spec.raw_offsets, joints0).clone()
    for i in range(1, spec.joints_num):
        offsets[i] = torch.linalg.norm(joints0[i] - joints0[parents[i]]) * offsets[i]
    return offsets


def inverse_kinematics(joints: torch.Tensor, spec: SkeletonSpec,
                       smooth_forward: bool = False) -> torch.Tensor:
    """(T, J, 3) joints -> (T, J, 4) local quaternions (`skeleton.py:55-103`)."""
    l_hip, r_hip, sdr_r, sdr_l = spec.face_joints
    across = (joints[:, r_hip] - joints[:, l_hip]) + (joints[:, sdr_r] - joints[:, sdr_l])
    across = across / torch.sqrt((across ** 2).sum(-1))[:, None]
    forward = torch.linalg.cross(_const([[0.0, 1.0, 0.0]], joints).expand_as(across), across)
    if smooth_forward:
        forward = gaussian_smooth(forward)
    forward = forward / torch.sqrt((forward ** 2).sum(-1))[..., None]

    target = _const([[0.0, 0.0, 1.0]], joints).expand_as(forward)
    root_quat = qbetween(forward, target)
    root_quat[0] = _const([1.0, 0.0, 0.0, 0.0], joints)  # first frame identity

    T = len(joints)
    quat_params = torch.zeros(joints.shape[:-1] + (4,), dtype=joints.dtype, device=joints.device)
    quat_params[:, 0] = root_quat
    raw = _const(spec.raw_offsets, joints)
    for chain in spec.chains:
        R = root_quat
        for j in range(len(chain) - 1):
            u = raw[chain[j + 1]][None].expand(T, 3)
            v = joints[:, chain[j + 1]] - joints[:, chain[j]]
            v = v / torch.sqrt((v ** 2).sum(-1))[:, None]
            R_loc = qmul(qinv(R), qbetween(u, v))
            quat_params[:, chain[j + 1]] = R_loc
            R = qmul(R, R_loc)
    return quat_params


def forward_kinematics(quat_params: torch.Tensor, root_pos: torch.Tensor,
                       offsets: torch.Tensor, spec: SkeletonSpec,
                       do_root_R: bool = True) -> torch.Tensor:
    """(T, J, 4) local quaternions + (T, 3) root -> (T, J, 3) joints
    (`skeleton.py:126-148`)."""
    T = len(quat_params)
    joints = torch.zeros(quat_params.shape[:-1] + (3,), dtype=quat_params.dtype,
                         device=quat_params.device)
    joints[:, 0] = root_pos
    for chain in spec.chains:
        R = (quat_params[:, 0] if do_root_R
             else _const([[1.0, 0.0, 0.0, 0.0]], quat_params).expand(T, 4))
        for i in range(1, len(chain)):
            R = qmul(R, quat_params[:, chain[i]])
            joints[:, chain[i]] = qrot(R, offsets[chain[i]][None].expand(T, 3)) \
                + joints[:, chain[i - 1]]
    return joints


def uniform_skeleton(positions: torch.Tensor, tgt_offsets: torch.Tensor,
                     spec: SkeletonSpec) -> torch.Tensor:
    """Retarget to the canonical skeleton (`motion_process.py:13-36`): the
    root trajectory scaled by the leg-length ratio, IK on the source, FK on
    the target offsets."""
    src_offsets = get_offsets_joints(positions[0], spec)
    l1, l2 = spec.leg_idx
    src_leg_len = src_offsets[l1].abs().max() + src_offsets[l2].abs().max()
    tgt_leg_len = tgt_offsets[l1].abs().max() + tgt_offsets[l2].abs().max()
    tgt_root = positions[:, 0] * (tgt_leg_len / src_leg_len)
    return forward_kinematics(inverse_kinematics(positions, spec), tgt_root, tgt_offsets, spec)


# ------------------------------------------------------------- process_file

def process_file(positions: torch.Tensor, spec: SkeletonSpec,
                 tgt_offsets: Optional[torch.Tensor] = None,
                 feet_thre: Optional[float] = None):
    """(T, J, 3) raw joints -> (T-1, F) feature vectors, float64, on the
    device of `positions` (`motion_process.py:169-360`). Returns
    (data, global_positions, local_positions, l_velocity)."""
    positions = torch.as_tensor(positions).to(torch.float64)[:, : spec.joints_num].clone()
    feet_thre = spec.feet_thre if feet_thre is None else feet_thre
    if tgt_offsets is not None:
        positions = uniform_skeleton(positions, tgt_offsets.to(positions), spec)

    # floor, origin, initial facing Z+ (`:177-213`)
    positions[:, :, 1] -= positions[..., 1].min()
    xz = _const([1.0, 0.0, 1.0], positions)
    positions = positions - positions[0, 0] * xz
    root_init = positions[0]
    r_hip, l_hip, sdr_r, sdr_l = spec.face_joints
    across = (root_init[r_hip] - root_init[l_hip]) + (root_init[sdr_r] - root_init[sdr_l])
    across = across / torch.sqrt((across ** 2).sum(-1))[..., None]
    forward_init = torch.linalg.cross(_const([[0.0, 1.0, 0.0]], positions), across[None])
    forward_init = forward_init / torch.sqrt((forward_init ** 2).sum(-1))[..., None]
    root_quat_init = qbetween(forward_init, _const([[0.0, 0.0, 1.0]], positions))
    positions = qrot(root_quat_init.expand(positions.shape[:-1] + (4,)), positions)
    global_positions = positions.clone()

    # foot contacts: summed squared frame deltas under the threshold
    # (`:229-249`; the threshold compares against the squared sum directly)
    def foot_contacts(idx):
        d2 = ((positions[1:, idx] - positions[:-1, idx]) ** 2).sum(-1)
        return (d2 < feet_thre).to(positions.dtype)

    feet_l = foot_contacts(list(spec.fid_l))
    feet_r = foot_contacts(list(spec.fid_r))

    # rot6d parameters with the smoothed forward (`get_cont6d_params`, `:283-304`)
    quat_params = inverse_kinematics(positions, spec, smooth_forward=True)
    cont_6d_params = quat_to_cont6d(quat_params)
    r_rot = quat_params[:, 0].clone()
    velocity = qrot(r_rot[1:], positions[1:, 0] - positions[:-1, 0])
    r_velocity = qmul(r_rot[1:], qinv(r_rot[:-1]))

    # rotation-invariant local positions (`get_rifke`, `:253-259`)
    J = positions.shape[1]
    local_pos = positions - positions[:, 0:1] * xz
    local_pos = qrot(r_rot[:, None].expand(-1, J, -1), local_pos)

    root_y = local_pos[:, 0, 1:2]
    r_vel_y = torch.arcsin(r_velocity[:, 2:3])       # y-axis rotation velocity
    l_velocity = velocity[:, [0, 2]]
    root_data = torch.cat([r_vel_y, l_velocity, root_y[:-1]], dim=-1)

    T = len(positions)
    rot_data = cont_6d_params[:, 1:].reshape(T, -1)
    ric_data = local_pos[:, 1:].reshape(T, -1)
    local_vel = qrot(r_rot[:-1, None].expand(-1, J, -1),
                     global_positions[1:] - global_positions[:-1]).reshape(T - 1, -1)
    data = torch.cat([root_data, ric_data[:-1], rot_data[:-1], local_vel,
                      feet_l, feet_r], dim=-1)
    return data, global_positions, local_pos, l_velocity
