"""Rotation conversions of the ego metrics, the rot6d forward kinematics
and the axis-angle readouts (`seeme_tpu/core/rotations.py:20-154`).

Quaternions are (w, x, y, z), as in the reference. Two 6-D layouts exist
(`EgoHMR/utils/geometry.py:47-66`): "prohmr" reads the six numbers as two
rows, "diffusion" as the first two columns of the matrix.
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


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz, by
    Shepperd's method without branches: the four candidates, the one whose
    pivot (trace or diagonal entry) is largest, sign fixed to w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    q = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                     1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    w0, x0, y0, z0 = (torch.sqrt(q.clamp_min(1e-12)) * 0.5).unbind(-1)
    cand = torch.stack([
        torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0), (m10 - m01) / (4 * w0)], -1),
        torch.stack([(m21 - m12) / (4 * x0), x0, (m01 + m10) / (4 * x0), (m02 + m20) / (4 * x0)], -1),
        torch.stack([(m02 - m20) / (4 * y0), (m01 + m10) / (4 * y0), y0, (m12 + m21) / (4 * y0)], -1),
        torch.stack([(m10 - m01) / (4 * z0), (m02 + m20) / (4 * z0), (m12 + m21) / (4 * z0), z0], -1),
    ], dim=-2)  # (..., 4 candidates, 4)
    pivot = torch.stack([tr, m00, m11, m22], dim=-1).argmax(-1)
    quat = torch.gather(cand, -2, pivot[..., None, None].expand(*pivot.shape, 1, 4))[..., 0, :]
    quat = quat * torch.where(quat[..., :1] < 0, -1.0, 1.0)
    return quat / torch.linalg.norm(quat, dim=-1, keepdim=True)


def quat_to_aa(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wxyz -> axis-angle (..., 3); near the
    identity (sin(angle/2) < 1e-7) the scale is its limit, 2."""
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w = quat[..., :1].clamp(-1.0, 1.0)
    xyz = quat[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(sin_half, w)
    scale = torch.where(sin_half < 1e-7, torch.full_like(angle, 2.0),
                        angle / sin_half.clamp_min(1e-12))
    return xyz * scale


def rotmat_to_aa(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3)."""
    return quat_to_aa(rotmat_to_quat(R))


def rot6d_to_rotmat(x: torch.Tensor, mode: str = "prohmr") -> torch.Tensor:
    """6-D representation (..., 6) -> rotation matrix (..., 3, 3) by
    Gram-Schmidt; the output's columns are (b1, b2, b1 x b2)."""
    batch = x.shape[:-1]
    if mode == "prohmr":
        m = x.reshape(*batch, 2, 3)
        a1, a2 = m[..., 0, :], m[..., 1, :]
    elif mode == "diffusion":
        m = x.reshape(*batch, 3, 2)
        a1, a2 = m[..., :, 0], m[..., :, 1]
    else:
        raise ValueError(f"unknown rot6d mode: {mode}")

    def normalize(v):
        return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-8)

    b1 = normalize(a1)
    b2 = normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def rotmat_to_rot6d(R: torch.Tensor, mode: str = "diffusion") -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> 6-D representation (..., 6): the first
    two columns, row-major ("diffusion") or as two 3-vectors ("prohmr")."""
    if mode == "diffusion":
        return R[..., :, :2].reshape(*R.shape[:-2], 6)
    if mode == "prohmr":
        return torch.stack([R[..., :, 0], R[..., :, 1]], dim=-2).reshape(*R.shape[:-2], 6)
    raise ValueError(f"unknown rot6d mode: {mode}")


def perspective_projection(points: torch.Tensor, translation: torch.Tensor,
                           focal_length: torch.Tensor,
                           camera_center: torch.Tensor | None = None,
                           rotation: torch.Tensor | None = None) -> torch.Tensor:
    """Pinhole projection of (B, N, 3) points -> (B, N, 2) pixels
    (`seeme_tpu/core/rotations.py:153`): optional camera rotation (B, 3, 3),
    the translation (B, 3), the perspective divide, the focal lengths (B, 2)
    and the optional principal point (B, 2)."""
    if rotation is not None:
        points = torch.einsum("bij,bkj->bki", rotation, points)
    points = points + translation[:, None, :]
    xy = points[..., :2] / points[..., 2:3] * focal_length[:, None, :]
    if camera_center is not None:
        xy = xy + camera_center[:, None, :]
    return xy
