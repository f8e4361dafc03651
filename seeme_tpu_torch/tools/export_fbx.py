"""Animated SMPL -> FBX export (bpy-backed), with a documented glTF fallback
(`scripts/export_fbx.py`).

Ports the role of the reference `scripts/fbx_output.py:1-345` (keyframed
animated SMPL mesh exported through Blender's FBX writer). The reference
drives a proprietary Unity SMPL .fbx template; this exporter builds the
scene from the repo's own data instead, so it needs no licensed template:

  * ``--mesh sample_0_mesh.npy [--faces faces.npy]`` — per-frame vertex
    animation as keyframed shape keys on the frame-0 mesh (the exact vertex
    sequence demo.py/fit.py produce), exported via
    ``bpy.ops.export_scene.fbx`` (`fbx_output.py:248-250`).
  * ``--poses poses.npy [--transl transl.npy] [--smpl SMPL_NEUTRAL.pkl]`` —
    a skinned armature built from the SMPL kinematic tree with per-frame
    quaternion bone keyframes from the axis-angle poses + pelvis location
    keyframes (`fbx_output.py:111-151` process_pose), LBS weights as vertex
    groups.

The reference's sibling `scripts/fbx_output_smplx.py` (a vendored
MPG-licensed VIBE tool) is deliberately out of scope: it keyframes a
*proprietary* `smplx-neutral.fbx` template (`fbx_output_smplx.py:40`) that
cannot be redistributed, and nothing in either pipeline produces SMPL-X
poses — the armature path below covers the same export role for the SMPL
skeletons this framework actually emits.

When ``bpy`` is not importable the exporter falls back to an OBJ sequence
for ``--mesh`` (`tools/export_obj.py::write_obj`) and to ``.glb`` for joints
and poses (`tools/export_gltf.py`), and says so — glTF is the SDK-free
interchange format every DCC tool imports; re-run where Blender's Python
has this repo on PYTHONPATH to get the .fbx itself. The ``--poses`` routes
compute the SMPL joints, on the card unless ``--device cpu`` is given (it
raises without a card); the others do no device work.

Usage:
  python -m seeme_tpu_torch.tools.export_fbx --mesh demo_out/sample_0_mesh.npy \
      --faces demo_out/faces.npy --out motion.fbx
  blender -b -P seeme_tpu_torch/tools/export_fbx.py -- --mesh ... --out motion.fbx
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

if __package__ in (None, ""):  # run as a file (`blender -b -P`): the package by path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    __package__ = "seeme_tpu_torch.tools"

SMPL_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                16, 17, 18, 19, 20, 21]
# `fbx_output.py:50-75` bone naming
BONE_NAMES = [
    "Pelvis", "L_Hip", "R_Hip", "Spine1", "L_Knee", "R_Knee", "Spine2",
    "L_Ankle", "R_Ankle", "Spine3", "L_Foot", "R_Foot", "Neck", "L_Collar",
    "R_Collar", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
]


def bpy_available() -> bool:
    try:
        import bpy  # noqa: F401

        return True
    except Exception:
        return False


def _reset_scene():
    import bpy

    bpy.ops.wm.read_factory_settings(use_empty=True)


def export_mesh_animation_fbx(vertices: np.ndarray, faces: np.ndarray,
                              out_path: str, fps: int = 20) -> str:
    """(T, V, 3) vertex sequence -> .fbx with keyframed shape keys."""
    import bpy

    _reset_scene()
    T = len(vertices)
    mesh = bpy.data.meshes.new("smpl")
    mesh.from_pydata(vertices[0].tolist(), [], faces.tolist())
    mesh.update()
    obj = bpy.data.objects.new("smpl", mesh)
    bpy.context.scene.collection.objects.link(obj)

    obj.shape_key_add(name="Basis")
    for t in range(T):
        key = obj.shape_key_add(name=f"frame_{t}")
        for vi, v in enumerate(vertices[t]):
            key.data[vi].co = v.tolist()
        # value 1 exactly at frame t, 0 at the neighbors
        for frame, value in ((t - 1, 0.0), (t, 1.0), (t + 1, 0.0)):
            if 0 <= frame < T:
                key.value = value
                key.keyframe_insert("value", frame=frame)

    scene = bpy.context.scene
    scene.render.fps = fps
    scene.frame_start, scene.frame_end = 0, T - 1
    obj.select_set(True)
    bpy.ops.export_scene.fbx(filepath=out_path, use_selection=True,
                             add_leaf_bones=False)
    return out_path


def export_skinned_fbx(poses: np.ndarray, transl: np.ndarray | None,
                       out_path: str, smpl_pkl: str | None = None,
                       fps: int = 20) -> str:
    """(T, 72) axis-angle poses (+ optional (T, 3) transl) -> skinned .fbx.

    Armature rest pose = SMPL template joints; per-frame bone quaternions
    from Rodrigues of the axis-angle pose (`fbx_output.py:111-151`), pelvis
    location from transl; mesh skinned by the LBS weights when a body model
    is available."""
    import bpy
    from mathutils import Matrix, Quaternion, Vector

    from ..core.rotations import aa_to_rotmat

    smpl = _body(smpl_pkl, torch.device("cpu"))
    v_template = smpl.v_template.numpy()
    joints0 = smpl.j_regressor.numpy() @ v_template  # (24, 3) rest joints
    weights = smpl.lbs_weights.numpy()               # (V, 24)
    faces = smpl.faces

    _reset_scene()
    arm_data = bpy.data.armatures.new("Armature")
    arm_obj = bpy.data.objects.new("Armature", arm_data)
    bpy.context.scene.collection.objects.link(arm_obj)
    bpy.context.view_layer.objects.active = arm_obj
    bpy.ops.object.mode_set(mode="EDIT")
    ebones = []
    for i, name in enumerate(BONE_NAMES):
        eb = arm_data.edit_bones.new(name)
        eb.head = Vector(joints0[i].tolist())
        # tail toward mean child (or a small offset for leaves)
        children = [j for j, p in enumerate(SMPL_PARENTS) if p == i]
        if children:
            eb.tail = Vector(joints0[children].mean(axis=0).tolist())
        else:
            eb.tail = Vector((joints0[i] + [0, 0.05, 0]).tolist())
        if SMPL_PARENTS[i] >= 0:
            eb.parent = ebones[SMPL_PARENTS[i]]
        ebones.append(eb)
    bpy.ops.object.mode_set(mode="OBJECT")

    if faces is not None:
        mesh = bpy.data.meshes.new("smpl")
        mesh.from_pydata(v_template.tolist(), [], np.asarray(faces).tolist())
        mesh.update()
        mesh_obj = bpy.data.objects.new("smpl", mesh)
        bpy.context.scene.collection.objects.link(mesh_obj)
        for i, name in enumerate(BONE_NAMES):
            vg = mesh_obj.vertex_groups.new(name=name)
            for vi in np.nonzero(weights[:, i] > 1e-6)[0]:
                vg.add([int(vi)], float(weights[vi, i]), "REPLACE")
        mod = mesh_obj.modifiers.new("Armature", "ARMATURE")
        mod.object = arm_obj
        mesh_obj.parent = arm_obj

    poses = np.asarray(poses).reshape(len(poses), -1, 3)[:, :24]
    rotmats = aa_to_rotmat(torch.as_tensor(poses.reshape(-1, 3), dtype=torch.float32)).numpy(
    ).reshape(len(poses), 24, 3, 3)
    pbones = arm_obj.pose.bones
    for b in pbones:
        b.rotation_mode = "QUATERNION"
    # Blender applies pose rotations in each bone's REST-LOCAL basis, while
    # SMPL local rotations are expressed in the parent-joint frame (identity
    # orientation at rest). The bones above are built with arbitrary
    # head->tail directions (toward the mean child), so a direct quaternion
    # assignment would distort every non-identity pose. Conjugate each
    # rotation into the bone's rest basis: q_i = M_i^-1 @ R_i @ M_i, with
    # M_i = rotation of rest `matrix_local`; by induction over the chain the
    # posed armature-space orientation is then exactly the SMPL world
    # rotation times the rest orientation, and Blender's skinning transform
    # P_i @ M_i^-1 matches SMPL's G_i @ G_rest_i^-1. (The reference gets
    # away with direct assignment only because its Unity template's bone
    # rests were authored for it, `fbx_output.py:111-151`.)
    rest = {
        name: np.array(arm_obj.data.bones[name].matrix_local.to_3x3())
        for name in BONE_NAMES
    }
    for t in range(len(poses)):
        for i, name in enumerate(BONE_NAMES):
            m = rest[name]
            q_mat = m.T @ rotmats[t, i] @ m  # rest basis is orthonormal
            q = Matrix(q_mat.tolist()).to_quaternion()
            pbones[name].rotation_quaternion = Quaternion(q)
            pbones[name].keyframe_insert("rotation_quaternion", frame=t)
        if transl is not None:
            # pose-bone location is rest-local too
            loc = rest[BONE_NAMES[0]].T @ np.asarray(transl[t], np.float64)
            pbones[BONE_NAMES[0]].location = Vector(loc.tolist())
            pbones[BONE_NAMES[0]].keyframe_insert("location", frame=t)

    scene = bpy.context.scene
    scene.render.fps = fps
    scene.frame_start, scene.frame_end = 0, len(poses) - 1
    bpy.ops.export_scene.fbx(filepath=out_path, add_leaf_bones=False)
    return out_path


def _body(smpl_pkl, device):
    """The SMPL file when it exists, else the 689-vertex synthetic body."""
    from ..core.smpl import load_smpl, synthetic_smpl

    if smpl_pkl and os.path.exists(smpl_pkl):
        return load_smpl(smpl_pkl, device)
    return synthetic_smpl(n_verts=689).to(device)


def pose_joints(poses: np.ndarray, smpl_pkl, device) -> np.ndarray:
    """(T, 72) axis-angle poses -> (T, 24, 3) joints at zero shape, on
    `device`."""
    from ..core.smpl import smpl_joints24

    aa = torch.as_tensor(np.asarray(poses, np.float32).reshape(-1, 72), device=device)
    with torch.no_grad():
        joints = smpl_joints24(_body(smpl_pkl, device), torch.zeros(len(aa), 10, device=device),
                               aa[:, 3:], aa[:, :3])
    return joints.cpu().numpy()


def _gltf_fallback(args) -> str:
    """SDK-free fallback: .glb via export_gltf (documented in the module
    docstring; re-run under Blender's Python for the .fbx itself)."""
    out = os.path.splitext(args.out)[0] + ".glb"
    if args.mesh:
        # vertex-cache animation: per-frame OBJs (export_obj contract)
        from .export_obj import write_obj

        verts = np.load(args.mesh)
        faces = (np.load(args.faces) if args.faces
                 else np.zeros((0, 3), np.int64))
        out_dir = os.path.splitext(args.out)[0] + "_obj"
        os.makedirs(out_dir, exist_ok=True)
        for t, v in enumerate(verts):
            write_obj(os.path.join(out_dir, f"frame_{t:04d}.obj"), v, faces)
        print(f"bpy unavailable: wrote OBJ sequence to {out_dir}/ "
              "(run under Blender's Python for .fbx)")
        return out_dir
    from .export_gltf import build_glb

    if args.poses:
        # FK the axis-angle poses to joints, export the animated-joint glb
        from .._device import resolve_device

        device = resolve_device("cpu" if args.cpu else args.device)
        joints = pose_joints(np.load(args.poses), args.smpl, device)
        if args.transl:
            joints = joints + np.load(args.transl)[:, None, :]
    else:
        joints = np.load(args.joints)
        if joints.ndim == 2:
            joints = joints.reshape(len(joints), -1, 3)
    with open(out, "wb") as f:
        f.write(build_glb(joints, args.fps))
    print(f"bpy unavailable: wrote {out} "
          "(run under Blender's Python for .fbx)")
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.tools.export_fbx")
    ap.add_argument("--mesh", default=None, help="(T, V, 3) vertex npy")
    ap.add_argument("--faces", default=None, help="(F, 3) faces npy")
    ap.add_argument("--poses", default=None, help="(T, 72) axis-angle npy")
    ap.add_argument("--transl", default=None, help="(T, 3) root transl npy")
    ap.add_argument("--joints", default=None,
                    help="(T, J, 3) joints npy (fallback glb only)")
    ap.add_argument("--smpl", default=None, help="SMPL_NEUTRAL.pkl path")
    ap.add_argument("--out", required=True, help="output .fbx path")
    ap.add_argument("--fps", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="where --poses computes the joints")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    args = ap.parse_args(argv)

    if not (args.mesh or args.poses or args.joints):
        ap.error("one of --mesh / --poses / --joints is required")

    if not bpy_available():
        return _gltf_fallback(args)

    if args.mesh:
        verts = np.load(args.mesh)
        faces = (np.load(args.faces) if args.faces
                 else np.zeros((0, 3), np.int32))
        out = export_mesh_animation_fbx(verts, faces, args.out, fps=args.fps)
    else:
        poses = np.load(args.poses)
        transl = np.load(args.transl) if args.transl else None
        out = export_skinned_fbx(poses, transl, args.out,
                                 smpl_pkl=args.smpl, fps=args.fps)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    # strip Blender's own argv when run as `blender -b -P script -- args`
    argv = sys.argv[1:]
    main(argv[argv.index("--") + 1:] if "--" in argv else argv)
