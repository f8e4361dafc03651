"""Rendering CLI (`render.py` at the repo root): npy joint or vertex
sequences -> videos.

    python -m seeme_tpu_torch.render [--cfg configs/render_mld.yaml]
        (--npy FILE | --dir DIR [--pairs]) [--mesh] [--faces FILE]
        [--mode video|sequence|frame] [--gt] [--fps 20] [--ext gif|mp4]
        [--out renders]

The flags and their order of precedence are the root script's: the
`RENDER:` block of `--cfg` (read through the port's `config/loader.py`)
gives defaults and a flag wins. `--npy` is one (T, J, 3) file, `--dir` a
folder of them (`pred_*.npy` with `--pairs`, each drawn over its `gt_*.npy`
when that file is there); a (T, V > 1000, 3) array, or any with `--mesh`,
is a vertex sequence drawn as a mesh (`render/mesh.py::render_mesh`:
Blender, then pyrender, then matplotlib) with the faces of `--faces`, else
those of the synthetic SMPL body (`core/smpl.py::synthetic_smpl(6890)`), as
`render.py:83-86` takes them. Rendering is host work: no device, no flag
for one. matplotlib is needed unless Blender or pyrender draws the mesh.
"""

from __future__ import annotations

import argparse
import os
import sys
from glob import glob
from typing import List, Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.render")
    ap.add_argument("--cfg", default=None,
                    help="render config yaml (configs/render_mld.yaml); its RENDER block "
                         "supplies defaults, flags override")
    ap.add_argument("--npy", default=None, help="single (T, J, 3) npy file")
    ap.add_argument("--dir", default=None, help="folder of npy files")
    ap.add_argument("--out", default="renders")
    ap.add_argument("--fps", type=int, default=None)
    ap.add_argument("--ext", default=None, choices=["gif", "mp4"])
    ap.add_argument("--pairs", action="store_true",
                    help="in --dir, overlay pred_*.npy with matching gt_*.npy")
    ap.add_argument("--mesh", action="store_true",
                    help="render SMPL mesh videos (vertex npys such as demo --mesh's "
                         "*_mesh.npy); detected for (T, V>1000, 3)")
    ap.add_argument("--faces", default=None,
                    help="(F, 3) faces npy; default the synthetic SMPL body's faces")
    ap.add_argument("--mode", default=None, choices=["video", "sequence", "frame"],
                    help="mesh render mode (reference blender/render.py)")
    ap.add_argument("--gt", action="store_true",
                    help="use the ground-truth (green) mesh material")
    return ap, ap.parse_args(argv)


def load_npy(path: str) -> np.ndarray:
    data = np.load(path, allow_pickle=True)
    if data.ndim == 2:  # (T, J*3)
        data = data.reshape(data.shape[0], -1, 3)
    return data


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Render every file; returns the written paths."""
    ap, args = parse_args(argv)
    if args.cfg:
        from ..config.loader import load_config

        r = load_config(args.cfg).get("RENDER") or {}
        args.npy = args.npy or (str(r.get("NPY", "")) or None)
        args.dir = args.dir or (str(r.get("DIR", "")) or None)
        args.mode = args.mode or str(r.get("MODE", "video"))
        args.fps = args.fps if args.fps is not None else int(r.get("FPS", 20))
        args.ext = args.ext or str(r.get("VID_EXT", "gif"))
        args.faces = args.faces or (str(r.get("FACES_PATH", "")) or None)
    args.mode = args.mode or "video"
    args.fps = args.fps if args.fps is not None else 20
    args.ext = args.ext or "gif"

    from .joints import blender_available, render_joints_video
    from .mesh import mesh_detect, render_mesh

    files = []
    if args.npy:
        files.append(args.npy)
    if args.dir:
        files.extend(sorted(glob(os.path.join(args.dir, "pred_*.npy" if args.pairs else "*.npy"))))
    if not files:
        ap.error("provide --npy or --dir" + (" (no pred_*.npy found)" if args.pairs else ""))
    if blender_available():
        print("bpy detected — Blender mesh backend active")
    faces = np.load(args.faces) if args.faces else None
    os.makedirs(args.out, exist_ok=True)
    written = []
    for f in files:
        data = load_npy(f)
        name = os.path.splitext(os.path.basename(f))[0]
        out = os.path.join(args.out, f"{name}.{args.ext}")
        if args.mesh or mesh_detect(data):
            if faces is None:
                from ..core.smpl import synthetic_smpl

                faces = synthetic_smpl(n_verts=6890).faces
            if faces.max() >= data.shape[1]:
                ap.error(f"faces index up to {faces.max()} but {f} has only "
                         f"{data.shape[1]} vertices — pass a matching --faces")
            path = render_mesh(data, faces, out, mode=args.mode, fps=args.fps, gt=args.gt,
                               title=name)
            print(f"rendered mesh {f} -> {path}")
        else:
            gt = None
            if args.pairs:
                gt_path = os.path.join(os.path.dirname(f),
                                       os.path.basename(f).replace("pred_", "gt_", 1))
                if os.path.exists(gt_path):
                    gt = load_npy(gt_path)
            path = render_joints_video(data, out, fps=args.fps, title=name, gt_joints=gt)
            print(f"rendered {f} -> {path}" + (" (+gt overlay)" if gt is not None else ""))
        written.append(path)
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
