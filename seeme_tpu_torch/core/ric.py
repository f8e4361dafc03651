"""HumanML3D RIC (rotation-invariant coordinate) feature recovery (`seeme_tpu/core/ric.py`).

`recover_root_rot_pos` and `recover_from_ric` of the reference's
`motion_process.py:362-430`, with the wxyz quaternion helpers. Feature
layout (263-d for 22 joints): [root_rot_vel (1) | root_linear_vel (2) |
root_y (1) | ric (J-1)*3 | rot (J-1)*6 | local_vel J*3 | foot contact (4)].
"""

from __future__ import annotations

import torch

from ..utils.profiling import count


def qinv(q: torch.Tensor) -> torch.Tensor:
    count("host_sync.ric_qinv")     # a copy from the host, on the card a wait
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = r.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by wxyz quaternions q (..., 4)."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v)
    uuv = torch.linalg.cross(qvec, uv)
    return v + 2 * (q[..., :1] * uv + uuv)


def recover_root_rot_pos(data: torch.Tensor):
    """(..., T, D) features -> (root quaternion (..., T, 4), root position (..., T, 3)).

    The root yaw is the cumulative rotation velocity shifted by one frame;
    root XZ is the cumulative yaw-derotated linear velocity; root Y is
    channel 3."""
    rot_vel = data[..., 0]
    r_rot_ang = torch.cumsum(
        torch.cat([torch.zeros_like(rot_vel[..., :1]), rot_vel[..., :-1]], dim=-1), dim=-1)
    zeros = torch.zeros_like(r_rot_ang)
    r_rot_quat = torch.stack([torch.cos(r_rot_ang), zeros, torch.sin(r_rot_ang), zeros], dim=-1)
    vel_xz = torch.cat([torch.zeros_like(data[..., :1, 1:3]), data[..., :-1, 1:3]], dim=-2)
    r_pos = torch.stack([vel_xz[..., 0], torch.zeros_like(vel_xz[..., 0]), vel_xz[..., 1]], dim=-1)
    r_pos = torch.cumsum(qrot(qinv(r_rot_quat), r_pos), dim=-2)
    r_pos = torch.stack([r_pos[..., 0], data[..., 3], r_pos[..., 2]], dim=-1)
    return r_rot_quat, r_pos


def recover_from_ric(data: torch.Tensor, joints_num: int) -> torch.Tensor:
    """(..., T, D) RIC features -> (..., T, joints_num, 3) joint positions."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4: (joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (joints_num - 1, 3))
    q = qinv(r_rot_quat)[..., None, :].expand(positions.shape[:-1] + (4,))
    positions = qrot(q, positions)
    offset = torch.stack([r_pos[..., 0], torch.zeros_like(r_pos[..., 1]), r_pos[..., 2]], dim=-1)
    positions = positions + offset[..., None, :]
    return torch.cat([r_pos[..., None, :], positions], dim=-2)
