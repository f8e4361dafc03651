"""Segment the raw EgoBody release into train/val/test recording lists
(`tools/segment_egobody.py`); a host tool, no device work.

    python -m seeme_tpu_torch.tools.segment_egobody --release DIR [--csv F] [--out DIR]
        [--link-npy]

Plays the role of the reference's `segment_seq_images.py:1-436`, which
hardcodes the split recording lists; here the splits come from the release's
own `data_splits.csv` / `data_info_release.csv` (columns hold recording names
per split), and the output is one `{split}.txt` list plus optional symlink
trees that `python -m seeme_tpu_torch.tools.preprocess_egobody --root`
consumes.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from glob import glob


def read_splits(csv_path: str):
    """data_splits.csv: columns 'train'/'val'/'test' of recording names."""
    splits = {"train": [], "val": [], "test": []}
    with open(csv_path) as f:
        reader = csv.DictReader(f)
        cols = {k.lower().strip(): k for k in reader.fieldnames or []}
        for row in reader:
            for split in splits:
                col = cols.get(split)
                if col and row.get(col, "").strip():
                    splits[split].append(row[col].strip())
    return splits


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.tools.segment_egobody")
    ap.add_argument("--release", required=True, help="raw EgoBody release root")
    ap.add_argument("--csv", default=None,
                    help="split csv (default: <release>/data_splits.csv)")
    ap.add_argument("--out", default=None, help="output root (default: release)")
    ap.add_argument("--link-npy", action="store_true",
                    help="symlink per-recording .npy shards into raw/{split}/")
    args = ap.parse_args(argv)

    csv_path = args.csv or os.path.join(args.release, "data_splits.csv")
    if not os.path.exists(csv_path):
        raise SystemExit(
            f"{csv_path} not found — the EgoBody release ships data_splits.csv"
        )
    out = args.out or args.release
    splits = read_splits(csv_path)

    for split, recs in splits.items():
        path = os.path.join(out, f"{split}.txt")
        with open(path, "w") as f:
            f.writelines(r + "\n" for r in recs)
        print(f"{split}: {len(recs)} recordings -> {path}")
        if args.link_npy:
            dst_dir = os.path.join(out, "raw", split)
            os.makedirs(dst_dir, exist_ok=True)
            for rec in recs:
                for src in glob(os.path.join(args.release, "**", rec + "*.npy"),
                                recursive=True):
                    dst = os.path.join(dst_dir, os.path.basename(src))
                    if not os.path.exists(dst):
                        os.symlink(os.path.abspath(src), dst)
    return splits


if __name__ == "__main__":
    main(sys.argv[1:])
