"""EgoHMR evaluation CLI (`test_egohmr.py` at the repo root).

    python -m seeme_tpu_torch.test_egohmr [--data_root DIR] [--checkpoint PT]
        [--batch_size 8] [--scene_points 1024] [--tiny] [--device cpu]

Respaced ancestral sampling (ddim50 over 1000 steps; `--tiny`: ddim10 over
100, GCN width 128 x 1 layer, 256 SMPL vertices, 64 x 64 crops) with the
visibility-guided fusion over the test split, and MPJPE / PA-MPJPE / V2V
plus MPJPE over the visible and the invisible joints, in mm. The noise comes
from one generator seeded with 1, drawn batch by batch: each batch's
initial sample, then one draw a step for every step but the last.
`evaluate_batch` is one batch's work (sampling, the ground truth, the
read-backs and the metrics), which the benchmark's `egohmr.test` cell runs
too. `--checkpoint` is a torch state dict with the reference's key names
(`best_model_mpjpe_vis.pt`, or `python -m seeme_tpu_torch.train_egohmr`'s
`model.pt`; `smpl.*` and `criterion.*` left out); without
one the seeded random init is evaluated. It runs on the card unless
`--device cpu` is given, and raises when there is no card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ._device import full_float32, resolve_device
from .core.smpl import synthetic_smpl
from .data.batch import eval_batches
from .data.egohmr_images import EgoHmrImageDataModule
from .data.synthetic import to_torch
from .eval.hmr_metrics import HmrMetrics
from .models.egohmr import EgoHmr, EgoHmrConfig
from .test_prohmr_scene import ground_truth, load_checkpoint, parse_args
from .utils.profiling import count, span

NOISE_SEED = 1


def evaluate_batch(model: EgoHmr, batch: Dict, generator: Optional[torch.Generator],
                   metrics: HmrMetrics, n_valid: int) -> Dict:
    """One batch: `EgoHmr.sample` with `generator`'s draws, the ground truth's
    SMPL, the first `n_valid` samples read back to the host, and
    `metrics.update`. Returns `sample`'s output."""
    out = model.sample(batch, generator=generator)
    with span("joints"):
        with span("joints.fk"):
            gt_j, gt_v = ground_truth(model, batch)

        def host(t: torch.Tensor) -> np.ndarray:
            count("host_sync.hmr_readback")   # a read-back, on the card a wait
            return t[:n_valid].cpu().numpy()

        metrics.update(host(out["pred_keypoints_3d"][:, :24]), host(out["pred_vertices"]),
                       host(gt_j), host(gt_v), host(out["vis_mask_smpl"]))
    return out


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
            evaluate_batch(model, to_torch(batch_np, dev), gen, metrics, n_valid)
    result = metrics.compute()
    for k, v in result.items():
        print(f"{k}: {v:.2f} mm")
    return result


if __name__ == "__main__":
    main()
