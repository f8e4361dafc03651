"""EgoBody / GIMO datamodule over preprocessed fixed-shape shards
(`seeme_tpu/data/egobody.py`), numpy only; GIMO's shards carry 66 pose
features (`pose_feats`).

`tools/preprocess_egobody.py` writes `{root}/processed/{split}.npz` with the
batch contract (`feats` (N, T, 2, P), `transl` (N, 2, T, 3), `betas`
(N, 2, T, 10), `cam` (N, T, 6), `length` (N,), optional `scene` (N, n, 3),
optional `image_crops` (N, K, 224, 224, 3) uint8) and `mean.npy`/`std.npy`
over the (P + 3)-wide feature vector; this module slices them, each split
to its first 10 rows under DEBUG (`seeme_tpu/data/egobody.py:50`, `:58-59`).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator

import numpy as np

from .batch import epoch_indices

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class EgoBodyDataModule:
    def __init__(self, root: str, pose_feats: int = 72, debug: bool = False):
        proc = os.path.join(root, "processed")
        if not os.path.isdir(proc):
            raise FileNotFoundError(
                f"{proc} not found: run tools/preprocess_egobody.py over the raw release first")
        self.mean = np.load(os.path.join(proc, "mean.npy")).reshape(-1)
        self.std = np.load(os.path.join(proc, "std.npy")).reshape(-1)
        self.nfeats = pose_feats + 3
        self.is_synthetic = False
        self._proc = proc
        self._splits: Dict[str, Dict[str, np.ndarray]] = {}
        self._debug = debug
        self.num_train = (self._load("train")["feats"].shape[0]
                          if os.path.exists(os.path.join(proc, "train.npz")) else 0)

    def _load(self, split: str) -> Dict[str, np.ndarray]:
        if split not in self._splits:
            data = dict(np.load(os.path.join(self._proc, f"{split}.npz")))
            self._splits[split] = {k: v[:10] for k, v in data.items()} if self._debug else data
        return self._splits[split]

    def split_array(self, split: str, key: str) -> np.ndarray:
        return self._load(split)[key]

    def attach_split_features(self, split: str, key: str, values: np.ndarray):
        data = self._load(split)
        if len(values) != data["feats"].shape[0]:
            raise ValueError(f"{key}: {len(values)} rows for a split of "
                             f"{data['feats'].shape[0]}")
        data[key] = np.asarray(values)

    def split_arrays(self, split: str) -> Dict[str, np.ndarray]:
        return self._load(split)

    def batch_indices(self, split: str, batch_size: int, shuffle=None, seed: int = 0,
                      drop_last: bool = True):
        if shuffle is None:
            shuffle = split == "train"
        return epoch_indices(self._load(split)["feats"].shape[0], batch_size, shuffle=shuffle,
                             seed=seed, drop_last=drop_last)

    def batches(self, split: str, batch_size: int, shuffle=None, seed: int = 0,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        data = self._load(split)
        rng = np.random.RandomState(seed + 1)
        cached_scene = "scene_feats" in data
        for sel in self.batch_indices(split, batch_size, shuffle=shuffle, seed=seed,
                                      drop_last=drop_last):
            # cached frozen scene features supersede the raw cloud
            batch = {k: v[sel] for k, v in data.items()
                     if k != "image_crops" and not (k == "scene" and cached_scene)}
            if "image_crops" in data:  # one random crop a sample (`dataset.py:1659-1660`)
                crops = data["image_crops"][sel]
                pick = rng.randint(0, crops.shape[1], size=len(sel))
                batch["image"] = imagenet_normalize(crops[np.arange(len(sel)), pick])
            yield batch


def imagenet_normalize(crops_uint8: np.ndarray) -> np.ndarray:
    """(..., H, W, 3) uint8 RGB -> ImageNet-normalized float32."""
    x = crops_uint8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD
