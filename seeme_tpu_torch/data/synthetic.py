"""Synthetic EgoBody-shaped data (`seeme_tpu/data/synthetic.py`).

A numpy copy of the JAX package's `SyntheticEgoDataset`: the same seed gives
the same arrays (smooth pose-space random walks, the interactee correlated
with the wearer, a Gaussian scene cloud).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class SyntheticEgoDataset:
    def __init__(self, num_samples: int = 64, motion_length: int = 60, pose_feats: int = 72,
                 scene_points: int = 1024, seed: int = 0):
        rng = np.random.RandomState(seed)
        T, P = motion_length, pose_feats

        def smooth_walk(shape, scale):
            steps = rng.randn(*shape).astype(np.float32) * scale
            x = np.cumsum(steps, axis=1)
            k = np.array([0.25, 0.5, 0.25], np.float32)
            return np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), 1, x)

        wearer = smooth_walk((num_samples, T, P), 0.05)
        interactee = -0.8 * wearer + smooth_walk((num_samples, T, P), 0.03)
        self.feats = np.stack([wearer, interactee], axis=2)  # (N, T, 2, P)
        self.transl = smooth_walk((num_samples, 2 * T, 3), 0.02).reshape(num_samples, 2, T, 3)
        self.betas = np.repeat(rng.randn(num_samples, 2, 1, 10).astype(np.float32) * 0.5,
                               T, axis=2)
        self.cam = np.abs(rng.randn(num_samples, T, 6).astype(np.float32))
        self.scene = rng.randn(num_samples, scene_points, 3).astype(np.float32)
        self.length = np.full((num_samples,), T, np.int32)
        flat = np.concatenate([self.feats[:, :, 0, :], self.transl[:, 0]],
                              axis=-1).reshape(-1, P + 3)
        self.mean = flat.mean(0)
        self.std = flat.std(0) + 1e-6

    def batch(self, start: int, batch_size: int) -> Dict[str, np.ndarray]:
        """Samples [start, start + batch_size) in order."""
        sel = slice(start, start + batch_size)
        return {"feats": self.feats[sel], "transl": self.transl[sel], "betas": self.betas[sel],
                "cam": self.cam[sel], "length": self.length[sel], "scene": self.scene[sel]}


def to_torch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in batch.items()}
