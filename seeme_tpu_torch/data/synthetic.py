"""Synthetic EgoBody/GIMO-shaped data (`seeme_tpu/data/synthetic.py`).

A numpy copy of the JAX package's `SyntheticEgoDataset`: the same seed gives
the same arrays (smooth pose-space random walks, the interactee correlated
with the wearer, a Gaussian scene cloud when the scene is a condition, and
striped images driven by the wearer's mean pose when the image is one) and
the same batches.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from .batch import epoch_indices


class SyntheticEgoDataset:
    def __init__(self, num_samples: int = 64, motion_length: int = 60, pose_feats: int = 72,
                 scene_points: int = 1024, with_scene: bool = True, with_image: bool = False,
                 image_size: int = 224, seed: int = 0):
        rng = np.random.RandomState(seed)
        T, P = motion_length, pose_feats
        self.num_samples = num_samples
        self.with_scene = with_scene
        self.with_image = with_image

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
        if with_scene:
            self.scene = rng.randn(num_samples, scene_points, 3).astype(np.float32)
        if with_image:
            # horizontal colour stripes from a fixed random projection of the
            # wearer's mean pose, plus noise: a learnable image signal
            proj = rng.randn(P, 3 * 8).astype(np.float32) * 0.5
            code = np.tanh(wearer.mean(axis=1) @ proj)                     # (N, 24)
            stripes = np.repeat(code.reshape(num_samples, 8, 1, 3), image_size // 8 + 1,
                                axis=1)[:, :image_size]                      # (N, H, 1, 3)
            self.image = (0.5 + 0.35 * stripes
                          + 0.1 * rng.rand(num_samples, image_size, image_size, 3)
                          ).clip(0, 1).astype(np.float32)
        self.length = np.full((num_samples,), T, np.int32)
        # per-sample arrays attached by the trainer (the frozen scene and
        # image features of the stage-2 cache), sliced into every batch
        self.extras: Dict[str, np.ndarray] = {}
        flat = np.concatenate([self.feats[:, :, 0, :], self.transl[:, 0]],
                              axis=-1).reshape(-1, P + 3)
        self.mean = flat.mean(0)
        self.std = flat.std(0) + 1e-6

    def __len__(self) -> int:
        return self.num_samples

    def _rows(self, sel) -> Dict[str, np.ndarray]:
        batch = {"feats": self.feats[sel], "transl": self.transl[sel], "betas": self.betas[sel],
                 "cam": self.cam[sel], "length": self.length[sel]}
        if self.with_scene and "scene_feats" not in self.extras:
            batch["scene"] = self.scene[sel]  # cached features supersede the raw cloud
        if self.with_image and "image_feats" not in self.extras:
            batch["image"] = self.image[sel]
        for k, v in self.extras.items():
            batch[k] = v[sel]
        return batch

    def batch(self, start: int, batch_size: int) -> Dict[str, np.ndarray]:
        """Samples [start, start + batch_size) in order."""
        return self._rows(slice(start, start + batch_size))

    def split_arrays(self) -> Dict[str, np.ndarray]:
        """All per-sample arrays (row i <-> sample i), attached extras included."""
        out = {"feats": self.feats, "transl": self.transl, "betas": self.betas, "cam": self.cam,
               "length": self.length}
        if self.with_scene:
            out["scene"] = self.scene
        if self.with_image:
            out["image"] = self.image
        out.update(self.extras)
        return out

    def batch_indices(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                      drop_last: bool = True):
        return epoch_indices(self.num_samples, batch_size, shuffle=shuffle, seed=seed,
                             drop_last=drop_last)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        for sel in self.batch_indices(batch_size, shuffle=shuffle, seed=seed,
                                      drop_last=drop_last):
            yield self._rows(sel)


def to_torch(batch: Dict, device) -> Dict:
    """A batch of numpy arrays (nested dicts of them too) as tensors on
    `device`; lists (captions) stay as they are."""
    return {k: to_torch(v, device) if isinstance(v, dict)
            else v if isinstance(v, list)
            else torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in batch.items()}
