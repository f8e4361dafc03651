"""Joint-motion -> glTF 2.0 (.glb) export (`scripts/export_gltf.py`),
numpy only.

The reference ships `scripts/fbx_output.py`, which drives the proprietary
Autodesk FBX Python SDK (not installed with this package). The
SDK-free equivalents in this package are `tools/export_bvh.py` (hierarchical
skeleton animation, imports into Blender/Maya/MotionBuilder) and this glTF
exporter (the modern interchange format: three.js, Blender, Unity, Unreal
all import .glb natively).

Output structure: one node per SMPL joint, each with a TRANSLATION animation
channel sampled at `--fps`; parent-child edges recorded in the node
hierarchy for viewers that draw bone lines.

Usage: python -m seeme_tpu_torch.tools.export_gltf --npy pred.npy --out motion.glb

A host tool: no device work.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys

import numpy as np

SMPL_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                16, 17, 18, 19, 20, 21]
JOINT_NAMES = [
    "pelvis", "l_hip", "r_hip", "spine1", "l_knee", "r_knee", "spine2",
    "l_ankle", "r_ankle", "spine3", "l_foot", "r_foot", "neck", "l_collar",
    "r_collar", "head", "l_shoulder", "r_shoulder", "l_elbow", "r_elbow",
    "l_wrist", "r_wrist", "l_hand", "r_hand",
]


def build_glb(joints: np.ndarray, fps: float = 20.0) -> bytes:
    """(T, J, 3) world-space joints -> GLB bytes (translation-animated
    nodes, J <= 24 uses SMPL names/hierarchy)."""
    T, J, _ = joints.shape
    joints = np.asarray(joints, np.float32)
    times = (np.arange(T) / fps).astype(np.float32)

    buf = bytearray()

    def push(arr: np.ndarray) -> tuple:
        offset = len(buf)
        data = arr.tobytes()
        buf.extend(data)
        while len(buf) % 4:
            buf.append(0)
        return offset, len(data)

    buffer_views = []
    accessors = []

    def accessor(arr, gltf_type):
        off, ln = push(arr)
        buffer_views.append({"buffer": 0, "byteOffset": off, "byteLength": ln})
        acc = {
            "bufferView": len(buffer_views) - 1,
            "componentType": 5126,  # FLOAT
            "count": int(arr.shape[0]),
            "type": gltf_type,
            "min": np.asarray(arr.reshape(arr.shape[0], -1).min(0)).tolist(),
            "max": np.asarray(arr.reshape(arr.shape[0], -1).max(0)).tolist(),
        }
        accessors.append(acc)
        return len(accessors) - 1

    t_acc = accessor(times[:, None], "SCALAR")
    # SCALAR min/max must be scalars-in-list; already is via reshape

    parents = SMPL_PARENTS if J == 24 else [-1] + [0] * (J - 1)
    names = JOINT_NAMES if J == 24 else [f"joint_{j}" for j in range(J)]

    nodes = []
    channels = []
    samplers = []
    for j in range(J):
        children = [c for c in range(J) if parents[c] == j]
        node = {"name": names[j], "translation": joints[0, j].tolist()}
        if children:
            node["children"] = children
        nodes.append(node)
        # world-space translations per frame; the node hierarchy is for
        # bone-line display only, so parent transforms stay identity and
        # every node is animated in world space
        out_acc = accessor(np.ascontiguousarray(joints[:, j]), "VEC3")
        samplers.append({"input": t_acc, "output": out_acc,
                         "interpolation": "LINEAR"})
        channels.append({"sampler": j,
                         "target": {"node": j, "path": "translation"}})
    # keep hierarchy flat in the scene to avoid double transforms: children
    # listed above are informational; glTF requires each node be referenced
    # once, so the scene roots are exactly the parentless nodes
    for node in nodes:
        node.pop("children", None)

    gltf = {
        "asset": {"version": "2.0", "generator": "seeme-tpu export_gltf"},
        "scene": 0,
        "scenes": [{"nodes": list(range(J))}],
        "nodes": nodes,
        "animations": [{
            "name": "motion",
            "samplers": samplers,
            "channels": channels,
        }],
        "buffers": [{"byteLength": len(buf)}],
        "bufferViews": buffer_views,
        "accessors": accessors,
    }

    json_bytes = json.dumps(gltf, separators=(",", ":")).encode()
    while len(json_bytes) % 4:
        json_bytes += b" "
    bin_bytes = bytes(buf)

    header = struct.pack("<4sII", b"glTF", 2,
                         12 + 8 + len(json_bytes) + 8 + len(bin_bytes))
    chunk_json = struct.pack("<II", len(json_bytes), 0x4E4F534A) + json_bytes
    chunk_bin = struct.pack("<II", len(bin_bytes), 0x004E4942) + bin_bytes
    return header + chunk_json + chunk_bin


def parse_glb(data: bytes) -> dict:
    """Read back the JSON chunk of a GLB (structural validation)."""
    magic, version, length = struct.unpack_from("<4sII", data, 0)
    assert magic == b"glTF" and version == 2 and length == len(data)
    json_len, json_type = struct.unpack_from("<II", data, 12)
    assert json_type == 0x4E4F534A
    return json.loads(data[20:20 + json_len])


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.tools.export_gltf")
    ap.add_argument("--npy", required=True, help="(T, J, 3) joints npy")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fps", type=float, default=20.0)
    args = ap.parse_args(argv)

    joints = np.load(args.npy)
    if joints.ndim == 2:
        joints = joints.reshape(len(joints), -1, 3)
    out = args.out or os.path.splitext(args.npy)[0] + ".glb"
    with open(out, "wb") as f:
        f.write(build_glb(joints, args.fps))
    print(f"wrote {out}: {joints.shape[0]} frames, {joints.shape[1]} joints")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
