"""Scene-encoding demo (`scene_encoder.py` at the repo root): the frozen
ProHMR scene PointNet, `ResnetPointnet(out 512, hidden 256)`, over one point
cloud.

    python -m seeme_tpu_torch.scene_encoder [--pcd FILE.npy] [--checkpoint PT]
        [--points 20000] [--device cpu | --cpu]

The cloud is `--pcd`'s (N, 3) array, else `--points` standard-normal points
from `numpy.random.RandomState(0)`, the root script's. The encoder runs
through the fused PointNet blocks (`ops/pointnet_fused.py`: kernels 1 and 2
at hidden width 256 on the card, one input-block and three split-block
launches); its weights come from `--checkpoint`, a torch state dict with the
encoder under `scene_enc.*` (a ProHMR-Scene checkpoint, as
`train_prohmr_scene` writes it) or `proscene.scene_enc.*` (a SEE-ME one),
else the seeded random init. It prints the embedding's shape and norm. It
runs on the card unless `--device cpu` (or `--cpu`) is given, and raises
when there is no card.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ._device import full_float32, resolve_device
from .nn.init import init_parameters_
from .nn.pointnet import ResnetPointnet
from .ops.pointnet_fused import FusedPointnet

PREFIXES = ("scene_enc.", "proscene.scene_enc.")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.scene_encoder")
    ap.add_argument("--pcd", default=None, help="(N, 3) npy point cloud; random if absent")
    ap.add_argument("--checkpoint", default=None, help="ProHMR-Scene or SEE-ME state dict")
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return ap.parse_args(argv)


def load_scene_encoder(enc: ResnetPointnet, path: str) -> str:
    """Load the encoder's tensors of a checkpoint, strictly; returns the
    prefix they were under."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    for prefix in PREFIXES:
        part = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if part:
            enc.load_state_dict(part, strict=True)
            return prefix
    raise KeyError(f"{path} has no scene encoder under {PREFIXES}")


def main(argv: Optional[Sequence[str]] = None) -> torch.Tensor:
    """Encode the cloud; returns the (1, 512) embedding."""
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)
    full_float32()
    enc = ResnetPointnet(out_dim=512, hidden_dim=256)
    init_parameters_(enc, torch.Generator().manual_seed(0))
    if args.checkpoint:
        prefix = load_scene_encoder(enc, args.checkpoint)
        print(f"loaded scene encoder ({prefix}*) from {args.checkpoint}")
    enc = enc.requires_grad_(False).eval().to(dev)
    if args.pcd:
        pcd = np.load(args.pcd).astype(np.float32).reshape(1, -1, 3)
    else:
        pcd = np.random.RandomState(0).randn(1, args.points, 3).astype(np.float32)
        print(f"no --pcd given: random cloud ({args.points} pts)")
    with torch.no_grad():
        feats = FusedPointnet()(enc, torch.as_tensor(pcd, device=dev))
    print(f"scene embedding: shape {tuple(feats.shape)}, norm {float(feats.norm()):.3f}")
    return feats


if __name__ == "__main__":
    main(sys.argv[1:])
