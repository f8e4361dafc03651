"""SMPL body model (`seeme_tpu/core/smpl.py:75-378`): the joints-only forward
kinematics of the losses and the eval path (`smpl_joints24`), and the full
linear-blend-skinning forward that gives the mesh (`smpl_forward`).

`load_smpl` reads the model file (`seeme_tpu/core/smpl.py:92-165`): the MPI
`.pkl`, whose chumpy arrays and sparse regressor unpickle without chumpy,
or its `.npz` cache. `synthetic_smpl` makes the same numpy `RandomState`
draws as the JAX package's, so both packages build the same body from one
seed.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..utils.profiling import count, span
from .rotations import aa_to_rotmat

NUM_JOINTS = 24
NUM_BETAS = 10

# Standard SMPL kinematic tree (parent of joint k); joint 0 = pelvis (root).
PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int64,
)

# smplx vertex_ids['smplh']: the 21 extra joints appended after the 24
# skeleton joints, in smplx's order (nose, eyes, ears, toes, heels, fingertips)
EXTRA_JOINT_VERTEX_IDS = np.array(
    [332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617, 6624, 6787,
     2746, 2319, 2445, 2556, 2673, 6191, 5782, 5905, 6016, 6133],
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


def _to_np(x: Any) -> np.ndarray:
    """A pickle field (ndarray, chumpy array or its stub, scipy sparse) as a
    dense ndarray."""
    if hasattr(x, "toarray"):  # scipy sparse
        return np.asarray(x.toarray())
    if hasattr(x, "r"):  # real chumpy
        return np.asarray(x.r)
    return np.asarray(x)  # ndarray, or _ChumpyStub through __array__


class _ChumpyStub:
    """Stands in for `chumpy.ch.Ch` while unpickling: the official SMPL pkls
    store chumpy objects whose state carries the dense array."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})

    def __array__(self, dtype=None, copy=None):
        for key in ("x", "v", "a"):
            if key in self.__dict__:
                return np.asarray(self.__dict__[key], dtype=dtype)
        raise ValueError("chumpy stub holds no array payload")


class _SmplUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        if module in ("scipy.sparse.csc", "scipy.sparse._csc"):
            import scipy.sparse

            return scipy.sparse.csc_matrix
        return super().find_class(module, name)


def load_smpl(path: str, device: str | torch.device = "cpu") -> SmplModel:
    """The SMPL model file (`.pkl` as MPI ships it, or an `.npz` cache) on
    `device`: the file contract of `smplx.SMPL(model_path=...)`. The shape
    blend shapes are cut to NUM_BETAS, the pose blend shapes stored (V, 3,
    207) become (207, V*3), the root's parent is -1, and the 21 extra joint
    vertices apply to the 6890-vertex body only."""
    if path.endswith(".npz"):
        data = dict(np.load(path, allow_pickle=True))
    else:
        with open(path, "rb") as f:
            data = _SmplUnpickler(f, encoding="latin1").load()

    v_template = _to_np(data["v_template"]).astype(np.float32)
    shapedirs = _to_np(data["shapedirs"]).astype(np.float32)[..., :NUM_BETAS]
    posedirs = _to_np(data["posedirs"]).astype(np.float32)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T
    j_regressor = _to_np(data["J_regressor"]).astype(np.float32)
    lbs_weights = _to_np(data["weights"]).astype(np.float32)
    parents = _to_np(data["kintree_table"])[0].astype(np.int64)
    parents[0] = -1
    faces = data.get("f", data.get("faces"))
    faces = None if faces is None else _to_np(faces).astype(np.int64)
    extra = EXTRA_JOINT_VERTEX_IDS if v_template.shape[0] == 6890 else None

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)

    return SmplModel(
        v_template=f32(v_template),
        shapedirs=f32(shapedirs),
        posedirs=f32(posedirs),
        j_regressor=f32(j_regressor),
        lbs_weights=f32(lbs_weights),
        parents=torch.as_tensor(parents, device=device),
        faces=faces,
        extra_joint_ids=None if extra is None else torch.as_tensor(extra, device=device),
    )


def save_smpl(model: SmplModel, path: str) -> None:
    """Write a body in the model file's layout, which `load_smpl` reads
    back bit for bit: an `.npz` cache, or the MPI `.pkl` (pickle protocol
    2), whose `v_template`, `shapedirs`, `posedirs` (V, 3, 207) and
    `weights` are `chumpy.ch.Ch` objects holding their array in `x`, with a
    `scipy.sparse` csc `J_regressor`, `kintree_table` (2, 24) and `f`. The
    chumpy class is a stand-in registered in `sys.modules` only while
    pickling: chumpy itself is not needed."""
    import sys
    import types

    import scipy.sparse

    arrays = {
        "v_template": model.v_template.cpu().numpy(),
        "shapedirs": model.shapedirs.cpu().numpy(),
        "posedirs": model.posedirs.cpu().numpy().T.reshape(-1, 3, model.posedirs.shape[0]),
        "weights": model.lbs_weights.cpu().numpy(),
    }
    parents = model.parents.cpu().numpy().astype(np.int64)
    kintree = np.stack([np.where(parents < 0, 2 ** 32 - 1, parents),
                        np.arange(len(parents))]).astype(np.int64)
    faces = model.faces if model.faces is not None else np.zeros((0, 3), np.int64)
    regressor = model.j_regressor.cpu().numpy()
    if path.endswith(".npz"):
        np.savez(path, J_regressor=regressor, kintree_table=kintree, f=faces, **arrays)
        return

    ch_mod = types.ModuleType("chumpy.ch")

    class Ch:
        def __init__(self, x):
            self.x = x

    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    ch_mod.Ch = Ch
    saved = {name: sys.modules.get(name) for name in ("chumpy", "chumpy.ch")}
    sys.modules["chumpy"] = types.ModuleType("chumpy")
    sys.modules["chumpy.ch"] = ch_mod
    try:
        data = {k: Ch(v) for k, v in arrays.items()}
        data.update(J_regressor=scipy.sparse.csc_matrix(regressor), kintree_table=kintree,
                    f=faces.astype(np.uint32))
        with open(path, "wb") as f:
            pickle.dump(data, f, protocol=2)
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


def smpl_body(path: str = "", device: str | torch.device = "cpu") -> SmplModel:
    """The body every path but the perception CLIs runs: the SMPL file at
    `path`, or the synthetic 6890-vertex body when `path` is empty."""
    return load_smpl(path, device) if path else synthetic_smpl(n_verts=6890).to(device)


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
    On the card the parents' read-back and the two copies from the host
    each wait for the stream.
    """
    count("host_sync.smpl_parents")
    if not np.array_equal(parents.cpu().numpy(), PARENTS):
        raise ValueError("parents table differs from the canonical SMPL tree")
    count("host_sync.smpl_parent_index")
    par = torch.as_tensor(np.clip(PARENTS, 0, None), device=joints.device)
    rel_pos = joints.clone()
    rel_pos[:, 1:] = joints[:, 1:] - joints[:, par[1:]]

    B = rot_mats.shape[0]
    top = torch.cat([rot_mats, rel_pos[..., None]], dim=-1)           # (B,24,3,4)
    count("host_sync.smpl_bottom_row")
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
    with span("joints.fk"):
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
