"""Latent-space visualization (`scripts/tsne.py`, the reference's
`scripts/tsne.py`).

    python -m seeme_tpu_torch.tools.tsne --cfg configs/config_NAME.yaml [--checkpoint PATH]
        [--num 128] [--out latents_tsne.png] [--device cpu | --cpu] [KEY.PATH=VALUE ...]

Encodes the test split's motions (batches of 16, the first `--num`) into
VAE latents (`MotionVae.encode`'s mean, of the wearer's features) on the
card, projects them to 2-D on the host (scikit-learn's t-SNE when it is
installed, PCA otherwise, as the JAX script chooses) and writes a scatter
plot. An ego config; weights from `--checkpoint` (a trainer's `<step>.pt`,
its experiment dir or `.../checkpoints/latest`), else the seeded random
init (SEED_VALUE). matplotlib is imported only to plot, at the end, and a
host without it gets an ImportError that names it. It runs on the card
unless `--device cpu` (or `--cpu`) is given, and raises when there is no
card.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@torch.no_grad()
def latents(system, datamodule, num: int) -> np.ndarray:
    """(num, latent_size * d) VAE latent means of the test split's first
    `num` samples, in batches of 16 (the last short batch dropped, as the
    JAX script's `batches` drops it)."""
    from ..data.synthetic import to_torch

    out, n = [], 0
    for batch in datamodule.batches("test", 16, shuffle=False):
        f = system.actor_features(to_torch(batch, system.device), 0)
        out.append(system.vae.encode(f)[0].reshape(len(f), -1).cpu().numpy())
        n += len(f)
        if n >= num:
            break
    return np.concatenate(out)[:num]


def project(z: np.ndarray) -> Tuple[np.ndarray, str]:
    """(N, 2) projection and its method: t-SNE (init "pca", perplexity
    min(30, N - 1)) when scikit-learn imports and runs, else PCA."""
    try:
        from sklearn.manifold import TSNE

        xy = TSNE(n_components=2, init="pca", perplexity=min(30, len(z) - 1)).fit_transform(z)
        return xy, "t-SNE"
    except (ImportError, ValueError):
        z0 = z - z.mean(0)
        _, _, vt = np.linalg.svd(z0, full_matrices=False)
        return z0 @ vt[:2].T, "PCA"


def compute(cfg_path: str, checkpoint: Optional[str] = None, num: int = 128,
            device: str | torch.device = "cuda",
            overrides: Sequence[str] = ()) -> Tuple[np.ndarray, np.ndarray, str]:
    """(z, xy, method) of a config: the latents on `device`, the projection
    on the host."""
    from .._device import full_float32, resolve_device
    from ..config.build import build_system
    from ..config.loader import load_config, parse_dotted_overrides
    from ..train.checkpoint import load_weights, resolve_latest

    dev = resolve_device(device)
    full_float32()
    cfg = load_config(cfg_path, overrides=parse_dotted_overrides(overrides))
    _, dm, system = build_system(cfg, dev)
    if checkpoint:
        load_weights(resolve_latest(checkpoint), system)
    system.eval()
    z = latents(system, dm, num)
    xy, method = project(z)
    return z, xy, method


def main(argv: Optional[Sequence[str]] = None) -> Tuple[np.ndarray, np.ndarray, str]:
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.tools.tsne")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--num", type=int, default=128)
    ap.add_argument("--out", default="latents_tsne.png")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("overrides", nargs="*", default=[], help="dotted YAML keys, KEY.PATH=VALUE")
    args = ap.parse_args(argv)
    z, xy, method = compute(args.cfg, args.checkpoint, args.num,
                            "cpu" if args.cpu else args.device, args.overrides)

    from ..render.joints import pyplot

    plt = pyplot()
    plt.figure(figsize=(5, 5))
    plt.scatter(xy[:, 0], xy[:, 1], s=8)
    plt.title(f"VAE latents ({method}, n={len(z)})")
    plt.savefig(args.out, dpi=120, bbox_inches="tight")
    plt.close()
    print(f"wrote {args.out} ({method})")
    return z, xy, method


if __name__ == "__main__":
    main(sys.argv[1:])
