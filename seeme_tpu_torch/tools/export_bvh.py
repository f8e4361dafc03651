"""Export a joint sequence to BVH for DCC import (`scripts/export_bvh.py`).

Plays the role of the reference's `scripts/fbx_output.py` (which drives the
Blender FBX exporter); BVH is dependency-free and imported by Blender/Maya/
MotionBuilder directly. Joint positions are exported as a per-joint
translation skeleton (position-only BVH), matching how the reference's npy
contract stores joints rather than rotations. A host tool: no device work.

    python -m seeme_tpu_torch.tools.export_bvh --joints sample_0.npy [--out F.bvh] [--fps 20]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core.smpl import PARENTS

SMPL_JOINT_NAMES = [
    "Pelvis", "L_Hip", "R_Hip", "Spine1", "L_Knee", "R_Knee", "Spine2",
    "L_Ankle", "R_Ankle", "Spine3", "L_Foot", "R_Foot", "Neck", "L_Collar",
    "R_Collar", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
]


def write_bvh(joints: np.ndarray, path: str, fps: float = 20.0) -> None:
    """joints: (T, 24, 3)."""
    T, J, _ = joints.shape
    if J < 24:
        raise ValueError(f"BVH export needs the 24 SMPL joints, got {J}")
    rest = joints[0]
    children = {j: [] for j in range(24)}
    for j in range(1, 24):
        children[PARENTS[j]].append(j)

    lines = ["HIERARCHY"]

    def emit(j, parent, indent):
        pad = "  " * indent
        tag = "ROOT" if parent is None else "JOINT"
        off = rest[j] - (rest[parent] if parent is not None else 0)
        lines.append(f"{pad}{tag} {SMPL_JOINT_NAMES[j]}")
        lines.append(pad + "{")
        lines.append(f"{pad}  OFFSET {off[0]:.6f} {off[1]:.6f} {off[2]:.6f}")
        lines.append(
            f"{pad}  CHANNELS 3 Xposition Yposition Zposition"
        )
        if children[j]:
            for c in children[j]:
                emit(c, j, indent + 1)
        else:
            lines.append(f"{pad}  End Site")
            lines.append(pad + "  {")
            lines.append(f"{pad}    OFFSET 0 0 0")
            lines.append(pad + "  }")
        lines.append(pad + "}")

    emit(0, None, 0)
    lines.append("MOTION")
    lines.append(f"Frames: {T}")
    lines.append(f"Frame Time: {1.0 / fps:.6f}")

    order = []

    def visit(j):
        order.append(j)
        for c in children[j]:
            visit(c)

    visit(0)
    for t in range(T):
        vals = []
        for j in order:
            p = PARENTS[j]
            local = joints[t, j] - (joints[t, p] if p >= 0 else 0)
            vals.extend(f"{v:.6f}" for v in local)
        lines.append(" ".join(vals))

    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.tools.export_bvh")
    ap.add_argument("--joints", required=True, help="(T, J, 3) npy")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fps", type=float, default=20.0)
    args = ap.parse_args(argv)
    joints = np.load(args.joints)
    out = args.out or args.joints.replace(".npy", ".bvh")
    write_bvh(joints[:, :24], out, args.fps)
    print(f"wrote {out} ({joints.shape[0]} frames)")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
