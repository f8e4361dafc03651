"""SMPL body model (`seeme_tpu/core/smpl.py:75-378`): the joints-only forward
kinematics of the losses and the eval path (`smpl_joints24`), and the full
linear-blend-skinning forward that gives the mesh (`smpl_forward`).

`synthetic_smpl` makes the same numpy `RandomState` draws as the JAX
package's, so both packages build the same body from one seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .rotations import aa_to_rotmat

NUM_JOINTS = 24
NUM_BETAS = 10

# Standard SMPL kinematic tree (parent of joint k); joint 0 = pelvis (root).
PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int64,
)


@dataclass(frozen=True)
class SmplModel:
    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, n_betas)
    posedirs: torch.Tensor     # (207, V*3)
    j_regressor: torch.Tensor  # (24, V)
    lbs_weights: torch.Tensor  # (V, 24)
    parents: torch.Tensor      # (24,) int64
    faces: np.ndarray | None = None
    extra_joint_ids: torch.Tensor | None = None

    def to(self, device) -> "SmplModel":
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return SmplModel(
            move(self.v_template), move(self.shapedirs), move(self.posedirs),
            move(self.j_regressor), move(self.lbs_weights), move(self.parents),
            self.faces, move(self.extra_joint_ids))


def synthetic_smpl(n_verts: int = 256, seed: int = 0) -> SmplModel:
    """Deterministic synthetic body with valid SMPL structure (the JAX
    package's `synthetic_smpl`, draw for draw)."""
    rng = np.random.RandomState(seed)
    v_template = rng.randn(n_verts, 3).astype(np.float32) * 0.3
    shapedirs = rng.randn(n_verts, 3, NUM_BETAS).astype(np.float32) * 0.01
    posedirs = rng.randn(n_verts, 3, 207).astype(np.float32) * 0.001
    posedirs = posedirs.reshape(-1, 207).T
    j_regressor = np.abs(rng.randn(NUM_JOINTS, n_verts).astype(np.float32))
    j_regressor *= rng.rand(NUM_JOINTS, n_verts) < (8.0 / n_verts)
    j_regressor += 1e-4
    j_regressor /= j_regressor.sum(axis=1, keepdims=True)
    lbs = np.abs(rng.randn(n_verts, NUM_JOINTS).astype(np.float32)) ** 4
    lbs /= lbs.sum(axis=1, keepdims=True)
    extra = rng.choice(n_verts, size=21, replace=False).astype(np.int64)
    faces = np.stack(
        [np.arange(n_verts - 2), np.arange(1, n_verts - 1), np.arange(2, n_verts)],
        axis=1,
    ).astype(np.int64)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)  # noqa: E731
    return SmplModel(
        v_template=f32(v_template),
        shapedirs=f32(shapedirs),
        posedirs=f32(posedirs),
        j_regressor=f32(j_regressor.astype(np.float32)),
        lbs_weights=f32(lbs),
        parents=torch.as_tensor(PARENTS),
        faces=faces,
        extra_joint_ids=torch.as_tensor(extra),
    )


def _rigid_transforms(rot_mats: torch.Tensor, joints: torch.Tensor,
                      parents: torch.Tensor):
    """Per-joint world transforms along the kinematic chain.

    rot_mats (B, 24, 3, 3), joints (B, 24, 3) rest positions. Returns
    (posed_joints (B, 24, 3), rel_transforms (B, 24, 4, 4)). The walk uses
    the canonical PARENTS table; a model with another table is refused.
    """
    if not np.array_equal(parents.cpu().numpy(), PARENTS):
        raise ValueError("parents table differs from the canonical SMPL tree")
    par = torch.as_tensor(np.clip(PARENTS, 0, None), device=joints.device)
    rel_pos = joints.clone()
    rel_pos[:, 1:] = joints[:, 1:] - joints[:, par[1:]]

    B = rot_mats.shape[0]
    top = torch.cat([rot_mats, rel_pos[..., None]], dim=-1)           # (B,24,3,4)
    bot = top.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(B, NUM_JOINTS, 1, 4)
    local_tf = torch.cat([top, bot], dim=-2)                          # (B,24,4,4)

    world = [local_tf[:, 0]]
    for k in range(1, NUM_JOINTS):
        world.append(world[int(PARENTS[k])] @ local_tf[:, k])
    world_tf = torch.stack(world, dim=1)

    posed_joints = world_tf[..., :3, 3]
    joints_h = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    correction = torch.einsum("bkij,bkj->bki", world_tf, joints_h)
    rel = world_tf.clone()
    rel[..., :, 3] = rel[..., :, 3] - correction
    return posed_joints, rel


def _rot_mats(body_pose: torch.Tensor, global_orient: torch.Tensor,
              pose2rot: bool) -> torch.Tensor:
    """(B, 24, 3, 3) local rotations from axis-angle (pose2rot) or from
    rotation matrices ((B, 23, 3, 3) pose, (B, 1, 3, 3) orientation)."""
    B = body_pose.shape[0]
    if pose2rot:
        aa = torch.cat([global_orient.reshape(B, 1, 3), body_pose.reshape(B, 23, 3)], dim=1)
        return aa_to_rotmat(aa)
    return torch.cat([global_orient.reshape(B, 1, 3, 3), body_pose.reshape(B, 23, 3, 3)], dim=1)


def smpl_joints24(
    model: SmplModel,
    betas: torch.Tensor,
    body_pose: torch.Tensor,
    global_orient: torch.Tensor,
    transl: torch.Tensor | None = None,
    pose2rot: bool = True,
) -> torch.Tensor:
    """The 24 skeleton joints, no vertex skinning: the regressor folded
    through the template and the shape blend shapes, then the chain."""
    rot_mats = _rot_mats(body_pose, global_orient, pose2rot)
    j_template = model.j_regressor @ model.v_template                       # (24, 3)
    j_shapedirs = torch.einsum("jv,vdn->jdn", model.j_regressor, model.shapedirs)
    joints_rest = j_template + torch.einsum("jdn,bn->bjd", j_shapedirs, betas)
    posed_joints, _ = _rigid_transforms(rot_mats, joints_rest, model.parents)
    if transl is not None:
        posed_joints = posed_joints + transl[:, None, :]
    return posed_joints


def smpl_forward(
    model: SmplModel,
    betas: torch.Tensor,
    body_pose: torch.Tensor,
    global_orient: torch.Tensor,
    transl: torch.Tensor | None = None,
    pose2rot: bool = True,
    return_vertices: bool = True,
) -> dict:
    """`smplx.SMPL.forward`: shape and pose blend shapes, the chain, linear
    blend skinning. Returns {"joints": (B, 24 [+ 21], 3)} (the 21 extra
    joints read off the mesh when the model has their vertex ids) and, with
    return_vertices, {"vertices": (B, V, 3)}."""
    B = betas.shape[0]
    rot_mats = _rot_mats(body_pose, global_orient, pose2rot)
    v_shaped = model.v_template + torch.einsum("vdn,bn->bvd", model.shapedirs, betas)
    joints_rest = torch.einsum("jv,bvd->bjd", model.j_regressor, v_shaped)
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, 207)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(B, -1, 3)
    posed_joints, rel_tf = _rigid_transforms(rot_mats, joints_rest, model.parents)

    vertices = None
    if return_vertices or model.extra_joint_ids is not None:
        vert_tf = torch.einsum("vk,bkm->bvm", model.lbs_weights,
                               rel_tf.reshape(B, NUM_JOINTS, 16)).reshape(B, -1, 4, 4)
        v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
        vertices = torch.einsum("bvij,bvj->bvi", vert_tf, v_h)[..., :3]
    joints = posed_joints
    if model.extra_joint_ids is not None:
        joints = torch.cat([joints, vertices[:, model.extra_joint_ids]], dim=1)
    if transl is not None:
        joints = joints + transl[:, None, :]
        if vertices is not None:
            vertices = vertices + transl[:, None, :]
    out = {"joints": joints}
    if return_vertices:
        out["vertices"] = vertices
    return out
