"""Operation counts of the flagship compute paths (`scripts/flops.py`), by
`torch.utils.flop_counter.FlopCounterMode`.

    python -m seeme_tpu_torch.tools.flops [--batch_size 64] [--device cpu | --cpu]

The six paths of the JAX script at `SeeMeConfig()` width on the synthetic
SMPL body (6890 vertices) and a synthetic batch: one denoiser forward (one
DDIM step), the VAE encode, the VAE decode, the scene PointNet over 20 000
points, the full sample (condition tokens, DDIM-50, decode) and the
diffusion loss. FlopCounterMode counts the products (matmul, bmm, addmm,
convolutions: 2 per multiply-add) that run through PyTorch's dispatcher, so
it cannot see the CUDA kernels, which run through `ctypes`: every path is
counted on its plain version (the PointNet module's own forward in place
of kernels 1 and 2, `ops/denoiser_fused.py::ddim_fused_plain` in place of
kernels 3 and 5), which is what the kernels' bounds in `chip_smoke.py`
count too. XLA's `cost_analysis()`, which the JAX script prints, counts
elementwise work as well. It runs on the card unless `--device cpu` (or
`--cpu`) is given, and raises when there is no card.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Optional, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode


def count(fn: Callable[[], object]) -> int:
    """The products `fn()` runs through PyTorch, in operations."""
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@torch.no_grad()
def path_flops(system, batch: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Operations of each of `scripts/flops.py`'s six paths for an ego
    system and a batch on its device, every path through its plain
    version."""
    from ..ops.denoiser_fused import ddim_fused_plain

    cfg = system.cfg
    B, T = batch["feats"].shape[:2]
    d = cfg.latent_dim[-1]
    dev = batch["feats"].device
    z = torch.zeros(B, *cfg.latent_dim, device=dev)
    scene_enc = system.proscene["scene_enc"]

    def cached(b):  # the plain PointNet's features in place of the fused blocks
        out = {k: v for k, v in b.items() if k != "scene"}
        out["scene_feats"] = scene_enc(b["scene"])
        return out

    def sample():
        cond = system.encode_conditioning(cached(batch))
        sd = system.kernel_operands()[0]
        zs = ddim_fused_plain(sd, cond, z, system.schedule, cfg.num_inference_timesteps,
                              cfg.num_layers, cfg.guidance_scale, md_trans=cfg.md_trans)
        return system.vae.decode(zs, T)

    gen = torch.Generator(device=dev).manual_seed(0)
    return {
        "denoiser fwd (1 DDIM step)": count(lambda: system.denoiser(
            z, torch.zeros(B, dtype=torch.long, device=dev), torch.zeros(B, 2, d, device=dev))),
        "vae encode": count(lambda: system.vae.encode(torch.zeros(B, T, cfg.nfeats, device=dev))),
        "vae decode": count(lambda: system.vae.decode(z, T)),
        f"scene pointnet ({batch['scene'].shape[1]} pts)": count(lambda: scene_enc(batch["scene"])),
        f"full sample (DDIM-{cfg.num_inference_timesteps} + decode)": count(sample),
        "diffusion train step loss": count(
            lambda: system.diffusion_loss(cached(batch), generator=gen)),
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, int]:
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.tools.flops")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    args = ap.parse_args(argv)

    from .._device import full_float32, resolve_device
    from ..core.smpl import synthetic_smpl
    from ..data.synthetic import SyntheticEgoDataset, to_torch
    from ..models.seeme import SeeMeConfig, SeeMeSystem

    dev = resolve_device("cpu" if args.cpu else args.device)
    full_float32()
    B, cfg = args.batch_size, SeeMeConfig()
    data = SyntheticEgoDataset(num_samples=B, motion_length=60, scene_points=cfg.scene_points)
    system = SeeMeSystem(cfg, synthetic_smpl(n_verts=6890), data.mean, data.std, device=dev,
                         seed=0)
    batch = to_torch(next(data.batches(B, shuffle=False)), dev)
    flops = path_flops(system, batch)
    for name, n in flops.items():
        print(f"{name:32s} {n / 1e9:10.2f} GFLOP")
    return flops


if __name__ == "__main__":
    main(sys.argv[1:])
