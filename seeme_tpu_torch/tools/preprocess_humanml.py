"""Raw HumanML3D / KIT joints -> RIC features (`tools/preprocess_humanml.py`,
the `__main__` block of the reference's
`mld/data/humanml/scripts/motion_process.py:434-520`).

    python -m seeme_tpu_torch.tools.preprocess_humanml --dataset humanml3d
        --joints_dir pose_data/joints [--example 000021.npy]
        --out_vecs new_joint_vecs [--out_joints new_joints] [--stats DIR]
        [--feet_thre X] [--device cpu | --cpu]

Every (T, J, 3) npy of `--joints_dir` is retargeted to the canonical
skeleton of `--example` (default: the first file) and turned into its 263-d
(humanml3d) or 251-d (kit) features, written to `--out_vecs`; the joints
recovered from them (`core/ric.py::recover_from_ric`, float32) go to
`--out_joints`; with `--stats`, `Mean.npy` / `Std.npy` over every feature
frame. Clips under 3 frames, clips whose processing fails and clips with
non-finite features are skipped and named, as in the root tool. One
sequence at a time, in float64 on the card unless `--device cpu` (or
`--cpu`) is given; it raises when there is no card.
"""

from __future__ import annotations

import argparse
import os
import sys
from glob import glob
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..core.motion_process import SPECS, get_offsets_joints, process_file
from ..core.ric import recover_from_ric


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.tools.preprocess_humanml")
    ap.add_argument("--dataset", default="humanml3d", choices=["humanml3d", "kit"])
    ap.add_argument("--joints_dir", required=True)
    ap.add_argument("--example", default=None,
                    help="npy defining the canonical skeleton (the reference uses 000021.npy "
                         "for t2m, 03950_gt.npy for kit); default: the first file")
    ap.add_argument("--out_vecs", required=True)
    ap.add_argument("--out_joints", default=None)
    ap.add_argument("--stats", default=None,
                    help="directory for Mean.npy / Std.npy over all feature frames")
    ap.add_argument("--feet_thre", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Process the folder; returns {"processed": [names], "skipped": [names],
    "frames": n}."""
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)
    spec = SPECS[args.dataset]
    files = sorted(glob(os.path.join(args.joints_dir, "*.npy")))
    if not files:
        raise SystemExit(f"no npy files in {args.joints_dir}")
    example = args.example or files[0]
    if not os.path.isabs(example) and not os.path.exists(example):
        example = os.path.join(args.joints_dir, example)
    ex = torch.as_tensor(np.load(example).reshape(-1, spec.joints_num, 3), dtype=torch.float64,
                         device=dev)
    tgt_offsets = get_offsets_joints(ex[0], spec)

    os.makedirs(args.out_vecs, exist_ok=True)
    if args.out_joints:
        os.makedirs(args.out_joints, exist_ok=True)
    feats, processed, skipped = [], [], []
    for f in files:
        raw = np.load(f)
        raw = raw.reshape(len(raw), -1, 3)[:, : spec.joints_num]
        if len(raw) < 3:
            print(f"skip {f}: too short ({len(raw)} frames)")
            skipped.append(os.path.basename(f))
            continue
        try:
            data = process_file(torch.as_tensor(raw, device=dev), spec, tgt_offsets=tgt_offsets,
                                feet_thre=args.feet_thre)[0]
        except Exception as e:  # a bad clip is skipped and named, as the reference does
            print(f"skip {f}: {e}")
            skipped.append(os.path.basename(f))
            continue
        if not bool(torch.isfinite(data).all()):
            print(f"skip {f}: non-finite features")
            skipped.append(os.path.basename(f))
            continue
        name = os.path.basename(f)
        np.save(os.path.join(args.out_vecs, name), data.cpu().numpy().astype(np.float32))
        if args.out_joints:
            rec = recover_from_ric(data.to(torch.float32), spec.joints_num)
            np.save(os.path.join(args.out_joints, name), rec.cpu().numpy())
        feats.append(data.cpu().numpy())
        processed.append(name)
    frames = sum(len(d) for d in feats)
    print(f"processed {len(feats)}/{len(files)} clips, {frames} frames "
          f"({frames / 20 / 60:.2f} min at 20 fps)")
    if args.stats and feats:
        cat = np.concatenate(feats, axis=0)
        np.save(os.path.join(args.stats, "Mean.npy"), cat.mean(0).astype(np.float32))
        np.save(os.path.join(args.stats, "Std.npy"), cat.std(0).astype(np.float32))
        print(f"wrote Mean.npy / Std.npy to {args.stats}")
    return {"processed": processed, "skipped": skipped, "frames": frames}


if __name__ == "__main__":
    main(sys.argv[1:])
