"""Convert a folder of .ply meshes to one (T, V, 3) vertex-sequence npy
(`scripts/plys2npy.py`, the reference's `scripts/plys2npy.py`). Minimal
ascii/binary-little PLY vertex reader — no external mesh dependency, no
device work.

    python -m seeme_tpu_torch.tools.plys2npy --dir FOLDER [--out meshes.npy]
"""

import argparse
import os
import sys
from glob import glob

import numpy as np


def read_ply_vertices(path):
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n_verts = next(int(l.split()[-1]) for l in header if l.startswith("element vertex"))
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        props = [l.split()[2] for l in header if l.startswith("property float")]
        if fmt == "ascii":
            verts = np.loadtxt(f, max_rows=n_verts, dtype=np.float32)[:, :3]
        else:
            data = f.read(n_verts * len(props) * 4)
            verts = np.frombuffer(data, "<f4").reshape(n_verts, len(props))[:, :3]
    return np.ascontiguousarray(verts)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.tools.plys2npy")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--out", default="meshes.npy")
    args = ap.parse_args(argv)
    files = sorted(glob(os.path.join(args.dir, "*.ply")))
    if not files:
        raise SystemExit(f"no .ply files in {args.dir}")
    seq = np.stack([read_ply_vertices(f) for f in files])
    np.save(args.out, seq)
    print(f"wrote {args.out}: {seq.shape}")
    return args.out


if __name__ == "__main__":
    main(sys.argv[1:])
