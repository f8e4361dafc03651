"""EgoHMR training CLI (`train_egohmr.py` at the repo root).

    python -m seeme_tpu_torch.train_egohmr [--data_root DIR] [--batch_size 8]
        [--epochs 2] [--lr 1e-4] [--weight_decay 1e-4] [--scene_points 1024]
        [--out experiments/egohmr/run] [--tiny] [--no-augment] [--device cpu]

One AdamW over every module (`EgoHMR/train_egohmr.py:1-257`) on
`EgoHmr.training_loss`: the x0-prediction MSE in the normalized
'diffusion' rot6d space, whose target `add_body_rep` builds from the
ground-truth SMPL parameters, plus the geometric losses. Batch norm keeps
its running statistics and trains them by gradient, as the JAX CLI does.
The scene encoder runs through the fused PointNet kernels on the card,
forward and backward.

`--tiny` is the root script's small model (GCN 128 x 1 layer, 100 diffusion
steps sampled as ddim10, 256 SMPL vertices, 64 x 64 crops). It runs on the
card unless `--device cpu` is given, and raises when there is no card;
products and convolutions run in full float32. It writes `<out>/model.pt`,
which `python -m seeme_tpu_torch.test_egohmr --checkpoint` loads.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ._device import full_float32, resolve_device
from .core.rotations import aa_to_rotmat, rotmat_to_rot6d
from .core.smpl import synthetic_smpl
from .data.egohmr_images import EgoHmrImageDataModule
from .data.synthetic import to_torch
from .models.egohmr import EgoHmr, EgoHmrConfig
from .train_prohmr_scene import NOISE_SEED, adamw, parse_args, save, step_draws

TINY = dict(gcn_hid_dim=128, gcn_layers=1, num_train_timesteps=100, timestep_respacing="ddim10")


def add_body_rep(model: EgoHmr, batch: Dict) -> Dict:
    """The ground-truth 'diffusion' rot6d of the 24 joints, normalized by the
    body_rep statistics, as `batch["body_rep"]` (`train_egohmr.py:67-78`)."""
    sp = batch["smpl_params"]
    B = sp["betas"].shape[0]
    aa = torch.cat([sp["global_orient"].reshape(B, 1, 3), sp["body_pose"].reshape(B, 23, 3)], 1)
    r6 = rotmat_to_rot6d(aa_to_rotmat(aa), mode="diffusion").reshape(B, 144)
    batch["body_rep"] = (r6 - model.body_rep_mean) / model.body_rep_std
    return batch


def train_step(model: EgoHmr, opt: torch.optim.AdamW, batch: Dict, draws: Dict) -> Dict:
    loss, terms = model.training_loss(batch, draws)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return {k: v.detach() for k, v in terms.items()}


def main(argv: Optional[Sequence[str]] = None, draws: Optional[Callable] = None) -> Dict:
    """Train; returns the epochs' mean losses (`losses`), their last
    diffusion MSEs (`mse`), the checkpoint's path and the model.
    `draws(step)` replaces the step's draws from the seeded generator: numpy
    arrays `t` (B,) int, `noise` (B, 144) and `drop` (B,) bool."""
    args = parse_args(argv, prog="train_egohmr", default_out="experiments/egohmr/run")
    dev = resolve_device(args.device)
    full_float32()
    cfg = EgoHmrConfig(**(TINY if args.tiny else {}))
    smpl = synthetic_smpl(n_verts=256 if args.tiny else 6890)
    model = EgoHmr(cfg, smpl, device=dev)
    dm = EgoHmrImageDataModule(root=args.data_root, n_pts=args.scene_points,
                               img_size=64 if args.tiny else 224, smpl=smpl)
    if dm.is_synthetic:
        print("no processed_images found -> synthetic data")
    model.requires_grad_(True)
    opt = adamw(model.parameters(), args)
    gen = torch.Generator(device=dev).manual_seed(NOISE_SEED)
    losses, mses, step = [], [], 0
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        totals = []
        for batch_np in dm.batches("train", args.batch_size, seed=epoch, augment=args.augment):
            batch = add_body_rep(model, to_torch(batch_np, dev))
            d = step_draws(draws, step, lambda: model.train_draws(args.batch_size, gen), dev)
            terms = train_step(model, opt, batch, d)
            totals.append(float(terms["total"]))
            step += 1
        losses.append(float(np.mean(totals)))
        mses.append(float(terms["diffusion_mse"]))
        print(f"epoch {epoch}: loss {losses[-1]:.4f} (mse {mses[-1]:.4f}, "
              f"{time.perf_counter() - t0:.1f}s)")
    model.requires_grad_(False)
    return {"losses": losses, "mse": mses, "checkpoint": save(model, args.out), "model": model}


if __name__ == "__main__":
    main()
