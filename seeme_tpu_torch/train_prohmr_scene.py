"""ProHMR-Scene training CLI (`train_prohmr_scene.py` at the repo root).

    python -m seeme_tpu_torch.train_prohmr_scene [--data_root DIR] [--batch_size 8]
        [--epochs 2] [--lr 1e-4] [--weight_decay 1e-4] [--scene_points 1024]
        [--out experiments/prohmr/run] [--tiny] [--no-augment] [--mocap NPZ]
        [--device cpu]

Alternating generator (G) and discriminator (D) AdamW steps
(`EgoHMR/train_prohmr_scene.py:1-218`): G over the backbone, the scene
encoder, the flow and its FC head (`compute_loss` plus the LSGAN term on
the discriminator's scores of every sample), D over the discriminator (the
fakes G made, detached, against unpaired poses of `MoCapDataset`, whose
synthetic fallback runs when `--mocap` is missing). ActNorm starts from the
first batch's ground-truth poses. Batch norm keeps its running statistics
and trains them by gradient, as the JAX CLI does. The scene encoder runs
through the fused PointNet kernels on the card, forward and backward.

`--tiny` is the root script's small model (flow hidden 128, depth 1, 256
SMPL vertices, 64 x 64 crops). It runs on the card unless `--device cpu` is
given, and raises when there is no card; products and convolutions run in
full float32. It writes `<out>/model.pt`, a state dict with the reference's
key names, which `python -m seeme_tpu_torch.test_prohmr_scene --checkpoint`
loads.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ._device import full_float32, resolve_device
from .core.rotations import aa_to_rotmat
from .core.smpl import synthetic_smpl
from .data.augmentation import MoCapDataset
from .data.egohmr_images import EgoHmrImageDataModule
from .data.synthetic import to_torch
from .models.prohmr import GENERATOR, ProHMRConfig, ProHMRScene, gt_pose_6d

NOISE_SEED = 1   # the step draws' generator (the JAX CLI's PRNGKey(1))
MOCAP_SEED = 3   # the discriminator's real-pose order (`train_prohmr_scene.py:86`)


def parse_args(argv: Optional[Sequence[str]] = None, prog: str = "train_prohmr_scene",
               default_out: str = "experiments/prohmr/run"):
    p = argparse.ArgumentParser(prog=f"python -m seeme_tpu_torch.{prog}")
    p.add_argument("--data_root", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--scene_points", type=int, default=1024)
    p.add_argument("--out", default=default_out)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--augment", dest="augment", action="store_true", default=True)
    p.add_argument("--no-augment", dest="augment", action="store_false")
    p.add_argument("--device", default="cuda")
    if prog == "train_prohmr_scene":
        p.add_argument("--mocap", default="data/datasets/cmu_mocap.npz")
    return p.parse_args(argv)


def adamw(params, args) -> torch.optim.AdamW:
    """optax.adamw(lr, weight_decay=wd): betas (0.9, 0.999), eps 1e-8,
    decay on every tensor. `foreach` updates in place and bumps the version
    counters that key the fused PointNet's kernel-layout weights."""
    return torch.optim.AdamW(params, lr=args.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=args.weight_decay, foreach=True)


def step_draws(draws: Optional[Callable], step: int, fallback: Callable, dev) -> Dict:
    """A step's random draws: `draws(step)` (numpy arrays) when given, else
    `fallback()`."""
    if draws is None:
        return fallback()
    return {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in draws(step).items()}


def g_step(model: ProHMRScene, opt: torch.optim.AdamW, params, batch: Dict, draws: Dict):
    """One generator update (`train_prohmr_scene.py:97-122`); returns the
    loss terms and the detached fakes."""
    out = model.forward_step(batch, noise=draws["flow"], train=True)
    loss, terms = model.compute_loss(batch, out, nll_noise=draws["nll"])
    B, NS = out["body_pose"].shape[:2]
    pose, betas = out["body_pose"].reshape(B * NS, 23, 3, 3), out["betas"].reshape(B * NS, 10)
    terms["loss_gen"] = ((model.discriminator_outputs(pose, betas) - 1.0) ** 2).sum() / B
    total = loss + model.cfg.loss_weights["ADVERSARIAL"] * terms["loss_gen"]
    for p, g in zip(params, torch.autograd.grad(total, params)):
        p.grad = g
    opt.step()
    return {k: v.detach() for k, v in terms.items()}, (pose.detach(), betas.detach())


def d_step(model: ProHMRScene, opt: torch.optim.AdamW, mocap: Dict, fake) -> torch.Tensor:
    """One discriminator update on the LSGAN loss (`train_prohmr_scene.py:131-149`)."""
    real_pose = aa_to_rotmat(mocap["body_pose"].reshape(-1, 23, 3))
    d_fake = model.discriminator_outputs(*fake)
    d_real = model.discriminator_outputs(real_pose, mocap["betas"])
    loss = model.cfg.loss_weights["ADVERSARIAL"] * (
        (d_fake ** 2).sum() / d_fake.shape[0] + ((d_real - 1.0) ** 2).sum() / d_real.shape[0])
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def save(model: torch.nn.Module, out: str) -> str:
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "model.pt")
    torch.save(model.state_dict(), path)
    print(f"saved {path}")
    return path


def main(argv: Optional[Sequence[str]] = None, draws: Optional[Callable] = None) -> Dict:
    """Train; returns the epochs' mean G losses (`g_losses`), their last D
    losses (`d_losses`), the checkpoint's path and the model. `draws(step)`
    replaces the step's draws from the seeded generator: numpy arrays
    `flow` (B, num_train_samples - 1, 144) and `nll` (B, 144)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    full_float32()
    cfg = ProHMRConfig(**(dict(flow_hidden=128, flow_depth=1) if args.tiny else {}))
    smpl = synthetic_smpl(n_verts=256 if args.tiny else 6890)
    model = ProHMRScene(cfg, smpl, device=dev)
    dm = EgoHmrImageDataModule(root=args.data_root, n_pts=args.scene_points,
                               img_size=64 if args.tiny else 224, smpl=smpl)
    if dm.is_synthetic:
        print("no processed_images found -> synthetic data")

    first = to_torch(next(dm.batches("train", args.batch_size, shuffle=False)), dev)
    with torch.no_grad():
        model.initialize_actnorm(gt_pose_6d(first["smpl_params"]),
                                 model.conditioning_features(first))
    print("ActNorm initialized on first batch")

    g_params = []
    for key in GENERATOR:
        getattr(model, key).requires_grad_(True)
        g_params += list(getattr(model, key).parameters())
    model.discriminator.requires_grad_(True)
    opt_g, opt_d = adamw(g_params, args), adamw(model.discriminator.parameters(), args)

    mocap = MoCapDataset(args.mocap)
    if mocap.is_synthetic:
        print(f"no mocap npz at {args.mocap} -> synthetic discriminator poses")
    mocap_iter = mocap.batches(args.batch_size * cfg.num_train_samples,
                               np.random.RandomState(MOCAP_SEED))
    gen = torch.Generator(device=dev).manual_seed(NOISE_SEED)
    g_losses, d_losses, step = [], [], 0
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses = []
        for batch_np in dm.batches("train", args.batch_size, seed=epoch, augment=args.augment):
            batch = to_torch(batch_np, dev)
            d = step_draws(draws, step, lambda: model.train_draws(args.batch_size, gen), dev)
            terms, fake = g_step(model, opt_g, g_params, batch, d)
            d_loss = d_step(model, opt_d, to_torch(next(mocap_iter), dev), fake)
            losses.append(float(terms["loss"]))
            step += 1
        g_losses.append(float(np.mean(losses)))
        d_losses.append(float(d_loss))
        print(f"epoch {epoch}: G loss {g_losses[-1]:.4f} D loss {d_losses[-1]:.5f} "
              f"({time.perf_counter() - t0:.1f}s)")
    model.requires_grad_(False)
    return {"g_losses": g_losses, "d_losses": d_losses, "checkpoint": save(model, args.out),
            "model": model}


if __name__ == "__main__":
    main()
