"""ProHMR-Scene evaluation CLI (`test_prohmr_scene.py` at the repo root).

    python -m seeme_tpu_torch.test_prohmr_scene [--data_root DIR] [--checkpoint PT]
        [--batch_size 8] [--scene_points 1024] [--tiny] [--device cpu]

The mode prediction (z = 0) over the test split, and MPJPE / PA-MPJPE /
V2V in mm. `--checkpoint` is a torch state dict with the reference's key
names (`best_model.pt`; `smpl.*` and the training-only `discriminator.*`
are left out); without one the seeded random init is evaluated. `--tiny`
is the root script's small model (flow hidden 128, depth 1, 256 SMPL
vertices, 64 x 64 crops). The body is the synthetic SMPL of
`core/smpl.py` and the data the synthetic correlated split until the real
files are in the repository. It runs on the card unless `--device cpu` is
given, and raises when there is no card; products and convolutions run in
full float32 there.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from ._device import full_float32, resolve_device
from .convert import load_reference_checkpoint
from .core.smpl import smpl_forward, synthetic_smpl
from .data.batch import eval_batches
from .data.egohmr_images import EgoHmrImageDataModule
from .data.synthetic import to_torch
from .eval.hmr_metrics import HmrMetrics
from .models.prohmr import ProHMRConfig, ProHMRScene


def parse_args(argv: Optional[Sequence[str]] = None, prog: str = "test_prohmr_scene"):
    p = argparse.ArgumentParser(prog=f"python -m seeme_tpu_torch.{prog}")
    p.add_argument("--data_root", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--scene_points", type=int, default=1024)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_checkpoint(model: torch.nn.Module, path: Optional[str], drop) -> None:
    if path:
        unused = load_reference_checkpoint(model, path, drop)
        print(f"loaded {path}" + (f" ({len(unused)} keys unused, e.g. {unused[:3]})"
                                  if unused else ""))
    else:
        print("no checkpoint — evaluating random init")


def ground_truth(model, batch: Dict):
    sp = batch["smpl_params"]
    gt = smpl_forward(model.smpl, sp["betas"], sp["body_pose"], sp["global_orient"])
    return gt["joints"][:, :24], gt["vertices"]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    full_float32()
    cfg = ProHMRConfig(num_test_samples=1, **(
        dict(flow_hidden=128, flow_depth=1) if args.tiny else {}))  # mode-only
    smpl = synthetic_smpl(n_verts=256 if args.tiny else 6890)
    model = ProHMRScene(cfg, smpl, device=dev)
    load_checkpoint(model, args.checkpoint, ("smpl",))
    dm = EgoHmrImageDataModule(root=args.data_root, n_pts=args.scene_points,
                               img_size=64 if args.tiny else 224, smpl=smpl)
    metrics = HmrMetrics()
    with torch.no_grad():
        for batch_np, n_valid in eval_batches(dm, "test", args.batch_size):
            batch = to_torch(batch_np, dev)
            out = model.forward_step(batch)
            gt_j, gt_v = ground_truth(model, batch)
            host = lambda t: t[:n_valid].cpu().numpy()  # noqa: E731
            metrics.update(host(out["pred_keypoints_3d"][:, 0, :24]),
                           host(out["pred_vertices"][:, 0]), host(gt_j), host(gt_v))
    result = metrics.compute()
    print(f"MPJPE:    {result['MPJPE']:.2f} mm")
    print(f"PA-MPJPE: {result['PA-MPJPE']:.2f} mm")
    print(f"V2V:      {result['V2V']:.2f} mm")
    return result


if __name__ == "__main__":
    main()
