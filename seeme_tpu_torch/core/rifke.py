"""Rifke: rotation-invariant joint features (Holden et al.), the
`seeme_tpu/core/rifke.py` port of `mld/transforms/joints2jfeats/rifke.py:11-150`
and its helpers (`joints2jfeats/tools.py`: the facing direction from hips
and shoulders, the soft-min floor height; `mld/utils/geometry.py:22`
`matrix_of_angles`), for the HumanML3D 22-joint layout, on the input's
device. It feeds the APE / AVE metrics (`eval/ape_ave.py`).

Feature layout (1 + (J-1)*3 + 1 + 2):
  [root height | root-relative yaw-derotated joint xyz | yaw velocity |
   yaw-derotated root XZ velocity]
"""

from __future__ import annotations

import torch

HUMANML3D_JOINTS = [
    "root", "RH", "LH", "BP", "RK", "LK", "BT", "RMrot", "LMrot", "BLN",
    "RF", "LF", "BMN", "RSI", "LSI", "BUN", "RS", "LS", "RE", "LE", "RW", "LW",
]
_J = {name: i for i, name in enumerate(HUMANML3D_JOINTS)}
_XZ = [0, 2]


def _softmin(x: torch.Tensor, softness: float = 0.5, dim: int = -1) -> torch.Tensor:
    maxi = (-x).amax(dim=dim)
    mini = (-x).amin(dim=dim)
    return -(maxi + torch.log(softness + torch.exp(mini - maxi)))


def get_floor(poses: torch.Tensor) -> torch.Tensor:
    """Soft-min height of the feet joints over time (`tools.py:33-46`)."""
    feet = poses[..., [_J["LMrot"], _J["LF"], _J["RMrot"], _J["RF"]], 1]
    return _softmin(feet.amin(dim=-1), softness=0.5, dim=-1)[..., None]


def get_forward_direction(poses: torch.Tensor) -> torch.Tensor:
    """Unit XZ facing direction from hips and shoulders (`tools.py:14-30`)."""
    across = (poses[..., _J["RH"], :] - poses[..., _J["LH"], :]
              + poses[..., _J["RS"], :] - poses[..., _J["LS"], :])
    forward = torch.stack([-across[..., 2], across[..., 0]], dim=-1)
    return forward / torch.linalg.norm(forward, dim=-1, keepdim=True).clamp_min(1e-8)


def _matrix_of_angles(cos: torch.Tensor, sin: torch.Tensor, inv: bool = False) -> torch.Tensor:
    sin = -sin if inv else sin
    return torch.stack([torch.stack([cos, -sin], dim=-1), torch.stack([sin, cos], dim=-1)],
                       dim=-2)


def joints_to_rifke(joints: torch.Tensor) -> torch.Tensor:
    """(..., T, 22, 3) joints -> (..., T, 1 + 21*3 + 1 + 2) features (`rifke.py:27-92`)."""
    floor = get_floor(joints)
    poses = torch.stack([joints[..., 0], joints[..., 1] - floor[..., None], joints[..., 2]],
                        dim=-1)
    translation = poses[..., 0, :]
    root_y = translation[..., 1]
    trajectory = translation[..., _XZ]

    poses = poses[..., 1:, :]
    poses = torch.stack([poses[..., 0] - trajectory[..., None, 0], poses[..., 1],
                         poses[..., 2] - trajectory[..., None, 1]], dim=-1)

    vel_traj = torch.diff(trajectory, dim=-2)
    vel_traj = torch.cat([0 * vel_traj[..., :1, :], vel_traj], dim=-2)

    forward = get_forward_direction(poses)
    angles = torch.atan2(forward[..., 0], forward[..., 1])
    vel_angles = torch.diff(angles, dim=-1)
    vel_angles = torch.cat([0 * vel_angles[..., :1], vel_angles], dim=-1)

    sin, cos = forward[..., 0], forward[..., 1]
    rot_inv = _matrix_of_angles(cos, sin, inv=True)
    poses_xz = torch.einsum("...lj,...jk->...lk", poses[..., _XZ], rot_inv)
    poses_local = torch.stack([poses_xz[..., 0], poses[..., 1], poses_xz[..., 1]], dim=-1)
    poses_features = poses_local.reshape(poses_local.shape[:-2] + (-1,))
    vel_traj_local = torch.einsum("...j,...jk->...k", vel_traj, rot_inv)
    return torch.cat([root_y[..., None], poses_features, vel_angles[..., None], vel_traj_local],
                     dim=-1)


def rifke_extract(features: torch.Tensor):
    """features -> (root_y, poses_features, vel_angles, vel_trajectory_local)."""
    return features[..., 0], features[..., 1:-3], features[..., -3], features[..., -2:]


def rifke_to_joints(features: torch.Tensor) -> torch.Tensor:
    """The inverse transform (`rifke.py:94-150`)."""
    root_y, poses_features, vel_angles, vel_traj_local = rifke_extract(features)
    angles = torch.cumsum(vel_angles, dim=-1)
    angles = angles - angles[..., :1]
    rot = _matrix_of_angles(torch.cos(angles), torch.sin(angles), inv=False)

    poses_local = poses_features.reshape(poses_features.shape[:-1] + (-1, 3))
    poses_xz = torch.einsum("...lj,...jk->...lk", poses_local[..., _XZ], rot)
    vel_traj = torch.einsum("...j,...jk->...k", vel_traj_local, rot)
    trajectory = torch.cumsum(vel_traj, dim=-2)
    trajectory = trajectory - trajectory[..., :1, :]
    poses = torch.stack([poses_xz[..., 0] + trajectory[..., None, 0], poses_local[..., 1],
                         poses_xz[..., 1] + trajectory[..., None, 1]], dim=-1)
    root = torch.stack([trajectory[..., 0], root_y, trajectory[..., 1]], dim=-1)[..., None, :]
    return torch.cat([root, poses], dim=-2)
