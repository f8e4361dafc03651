"""EgoHMR evaluation CLI (`test_egohmr.py` at the repo root).

    python -m seeme_tpu_torch.test_egohmr [--data_root DIR] [--checkpoint PT]
        [--batch_size 8] [--scene_points 1024] [--tiny] [--device cpu]

Respaced ancestral sampling (ddim50 over 1000 steps; `--tiny`: ddim10 over
100, GCN width 128 x 1 layer, 256 SMPL vertices, 64 x 64 crops) with the
visibility-guided fusion over the test split, and MPJPE / PA-MPJPE / V2V
plus MPJPE over the visible and the invisible joints, in mm. The noise comes
from one generator seeded with 1, drawn batch by batch: each batch's
initial sample, then one draw a step for every step but the last.
`--checkpoint` is a torch state dict with the reference's key names
(`best_model_mpjpe_vis.pt`, or `python -m seeme_tpu_torch.train_egohmr`'s
`model.pt`; `smpl.*` and `criterion.*` left out); without
one the seeded random init is evaluated. It runs on the card unless
`--device cpu` is given, and raises when there is no card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ._device import full_float32, resolve_device
from .core.smpl import synthetic_smpl
from .data.batch import eval_batches
from .data.egohmr_images import EgoHmrImageDataModule
from .data.synthetic import to_torch
from .eval.hmr_metrics import HmrMetrics
from .models.egohmr import EgoHmr, EgoHmrConfig
from .test_prohmr_scene import ground_truth, load_checkpoint, parse_args

NOISE_SEED = 1


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = parse_args(argv, prog="test_egohmr")
    dev = resolve_device(args.device)
    full_float32()
    if args.tiny:
        cfg = EgoHmrConfig(gcn_hid_dim=128, gcn_layers=1, num_train_timesteps=100,
                           timestep_respacing="ddim10")
    else:
        cfg = EgoHmrConfig()
    smpl = synthetic_smpl(n_verts=256 if args.tiny else 6890)
    model = EgoHmr(cfg, smpl, device=dev)
    load_checkpoint(model, args.checkpoint, ("smpl", "criterion"))
    dm = EgoHmrImageDataModule(root=args.data_root, n_pts=args.scene_points,
                               img_size=64 if args.tiny else 224, smpl=smpl)
    gen = torch.Generator(device=dev).manual_seed(NOISE_SEED)
    metrics = HmrMetrics()
    with torch.no_grad():
        for batch_np, n_valid in eval_batches(dm, "test", args.batch_size):
            batch = to_torch(batch_np, dev)
            out = model.sample(batch, generator=gen)
            gt_j, gt_v = ground_truth(model, batch)
            host = lambda t: t[:n_valid].cpu().numpy()  # noqa: E731
            metrics.update(host(out["pred_keypoints_3d"][:, :24]), host(out["pred_vertices"]),
                           host(gt_j), host(gt_v), host(out["vis_mask_smpl"]))
    result = metrics.compute()
    for k, v in result.items():
        print(f"{k}: {v:.2f} mm")
    return result


if __name__ == "__main__":
    main()
