"""EgoBody batches, after the repository's synthetic EgoBody recipe: smooth
random walks of the wearer's pose features, the interactee mirrored from
them with its own walk, walked translations, per-sequence shapes, and a
Gaussian scene cloud. The mix gives `motion` (`wearer_step`,
`interactee_step`, `interactee_mirror`, `transl_step`, `betas_scale`) and
`scene` (`scale`)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.systems import generator


def smooth_walk(g: torch.Generator, shape, step: float, device) -> torch.Tensor:
    """Random walks along dim 1, smoothed by [1/4, 1/2, 1/4] with zeros past
    the ends."""
    x = torch.cumsum(torch.randn(shape, generator=g, device=device) * step, dim=1)
    p = F.pad(x, (0, 0, 1, 1))
    return 0.25 * p[:, :-2] + 0.5 * p[:, 1:-1] + 0.25 * p[:, 2:]


def batch(traffic, i: int) -> Dict[str, torch.Tensor]:
    """An EgoBody batch in the port's layout: feats (B, T, 2, 72), transl
    (B, 2, T, 3), betas (B, 2, T, 10), scene (B, N, 3), length."""
    conf, mix, dev = traffic.conf, traffic.mix, traffic.device
    c, m = conf["config"], mix["motion"]
    g = generator(traffic.seed, "batch", dev, i)
    B, T, N = traffic.batch_size, int(c["MOTION_LENGTH"]), int(c["model"]["scene_points"])
    P = 72
    wearer = smooth_walk(g, (B, T, P), m["wearer_step"], dev)
    other = m["interactee_mirror"] * wearer + smooth_walk(g, (B, T, P), m["interactee_step"], dev)
    betas = torch.randn(B, 2, 1, conf["smpl_betas"], generator=g, device=dev)
    return {
        "feats": torch.stack([wearer, other], dim=2),
        "transl": smooth_walk(g, (B, 2 * T, 3), m["transl_step"], dev).reshape(B, 2, T, 3),
        "betas": (betas * m["betas_scale"]).expand(-1, -1, T, -1).contiguous(),
        "scene": torch.randn(B, N, 3, generator=g, device=dev) * mix["scene"]["scale"],
        "length": torch.full((B,), T, dtype=torch.int64, device=dev),
    }
