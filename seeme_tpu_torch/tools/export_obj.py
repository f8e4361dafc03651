"""Saved SMPL vertex arrays -> per-frame Wavefront OBJ meshes
(`scripts/export_obj.py`).

The reference's `results_ours_gimo/compute_trimesh.py:1-62` loads the saved
gt/pred vertex dicts (`dict_{gt,pred}_*.npy`, values flattened (N*60, 6890, 3)
sequences) and writes one mesh file per frame via trimesh. trimesh is not a
dependency here; OBJ is plain text, so this exporter needs none.

Inputs accepted:
  * a plain (T, V, 3) or (N, T, V, 3) vertex npy (e.g. demo.py --mesh output),
  * a dict npy of {seq_name: (N*T, V, 3)} like the reference's result dicts
    (reshaped with --frames-per-seq, default 60 as in compute_trimesh.py:29).

Faces come from --faces (a (F, 3) npy, the reference's `faces.npy`) or from
the SMPL pkl when present (`config/build.py::load_smpl_or_synthetic`);
otherwise the synthetic SMPL topology is used so the tool stays runnable
asset-free. It reads faces only and computes no vertices: no device work.

Usage:
  python -m seeme_tpu_torch.tools.export_obj --npy dict_pred_gimo.npy --out trimesh_gimo
  python -m seeme_tpu_torch.tools.export_obj --npy pred_mesh.npy --faces faces.npy --out meshes
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("# seeme-tpu OBJ export\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces + 1:  # OBJ indices are 1-based
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def load_faces(args, n_verts: int) -> np.ndarray:
    if args.faces and os.path.exists(args.faces):
        return np.load(args.faces).astype(np.int64)
    from ..config.build import load_smpl_or_synthetic
    from ..config.loader import Config

    smpl = load_smpl_or_synthetic(Config({"model": {"smpl_path": args.smpl}}))
    if smpl.faces is None or smpl.v_template.shape[0] != n_verts:
        raise SystemExit(
            f"faces for {n_verts} verts unavailable (SMPL has "
            f"{smpl.v_template.shape[0]}); pass --faces"
        )
    return np.asarray(smpl.faces)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.tools.export_obj",
                                description=__doc__)
    p.add_argument("--npy", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--faces", default=None, help="(F,3) faces npy")
    p.add_argument("--smpl", default="./deps/smpl_models/smpl/SMPL_NEUTRAL.pkl")
    p.add_argument("--frames-per-seq", type=int, default=60,
                   help="sequence length for dict inputs (compute_trimesh.py:29)")
    p.add_argument("--stride", type=int, default=1, help="export every k-th frame")
    args = p.parse_args(argv)

    data = np.load(args.npy, allow_pickle=True)
    if data.dtype == object:  # reference result-dict format
        seqs = data.item()
        seqs = {
            k: np.asarray(v).reshape(-1, args.frames_per_seq,
                                     *np.asarray(v).shape[-2:])
            for k, v in seqs.items()
        }
    else:
        arr = np.asarray(data, np.float32)
        if arr.ndim == 3:
            arr = arr[None]
        seqs = {"seq": arr}

    os.makedirs(args.out, exist_ok=True)
    first = next(iter(seqs.values()))
    faces = load_faces(args, first.shape[-2])
    n = 0
    for name, arr in seqs.items():  # (N, T, V, 3)
        for i, seq in enumerate(arr):
            d = os.path.join(args.out, f"{name}_{i:03d}")
            os.makedirs(d, exist_ok=True)
            for t in range(0, seq.shape[0], args.stride):
                write_obj(os.path.join(d, f"frame_{t:04d}.obj"), seq[t], faces)
                n += 1
    print(f"wrote {n} OBJ meshes under {args.out}")
    return n


if __name__ == "__main__":
    main(sys.argv[1:])
