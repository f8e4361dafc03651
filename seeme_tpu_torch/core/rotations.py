"""Rotation conversions used by the ego metrics (`seeme_tpu/core/rotations.py:20-60`).

Quaternions are (w, x, y, z), as in the reference.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def aa_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternion (..., 4), wxyz. The epsilon sits
    inside the norm, as in `EgoHMR/utils/geometry.py:5-21`."""
    angle = torch.linalg.norm(aa + _EPS, dim=-1, keepdim=True)
    axis = aa / angle
    half = angle * 0.5
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Unit-normalizes then converts quaternion (..., 4) wxyz -> (..., 3, 3)."""
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return m.reshape(quat.shape[:-1] + (3, 3))


def aa_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues via quat)."""
    return quat_to_rotmat(aa_to_quat(aa))
