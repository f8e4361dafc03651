"""Dataset name -> datamodule (`seeme_tpu/data/registry.py:34-96`).

EgoBody loads the preprocessed release (`data/egobody.py`) when
`<root>/EgoBody` exists; otherwise `SyntheticDataModule` keeps the path
runnable, as the JAX package does (256 train, 64 val and 64 test samples
from seeds 0, 1 and 2).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from .egobody import EgoBodyDataModule
from .synthetic import SyntheticEgoDataset


class SyntheticDataModule:
    """Per-split `SyntheticEgoDataset`s with the datamodule interface."""

    def __init__(self, condition: Sequence[str] = (), motion_length: int = 60,
                 scene_points: int = 1024):
        with_scene = "scene" in condition
        num_train, num_eval = 256, 64
        common = dict(motion_length=motion_length, pose_feats=72,
                      scene_points=max(scene_points if with_scene else 0, 1),
                      with_scene=with_scene)
        self.train_set = SyntheticEgoDataset(num_train, seed=0, **common)
        self.val_set = SyntheticEgoDataset(num_eval, seed=1, **common)
        self.test_set = SyntheticEgoDataset(num_eval, seed=2, **common)
        self.mean = self.train_set.mean
        self.std = self.train_set.std
        self.num_train = len(self.train_set)
        self.is_synthetic = True

    def _split(self, split: str) -> SyntheticEgoDataset:
        return getattr(self, f"{split}_set")

    def batches(self, split: str, batch_size: int, shuffle=None, seed: int = 0,
                drop_last: bool = True):
        if shuffle is None:
            shuffle = split == "train"
        return self._split(split).batches(batch_size, shuffle=shuffle, seed=seed,
                                          drop_last=drop_last)

    def split_arrays(self, split: str):
        return self._split(split).split_arrays()

    def batch_indices(self, split: str, batch_size: int, shuffle=None, seed: int = 0,
                      drop_last: bool = True):
        if shuffle is None:
            shuffle = split == "train"
        return self._split(split).batch_indices(batch_size, shuffle=shuffle, seed=seed,
                                                drop_last=drop_last)

    def split_array(self, split: str, key: str) -> np.ndarray:
        return getattr(self._split(split), key)

    def attach_split_features(self, split: str, key: str, values: np.ndarray):
        """Attach a per-sample feature array (row i <-> sample i) that every
        batch then carries: the stage-2 cache of frozen scene features."""
        ds = self._split(split)
        if len(values) != len(ds):
            raise ValueError(f"{key}: {len(values)} rows for a split of {len(ds)}")
        ds.extras[key] = np.asarray(values)


def get_datamodule(name: str, condition: Sequence[str] = (), motion_length: int = 60,
                   scene_points: int = 1024, root: str = "./datasets"):
    """The datamodule of DATASET_NAME `name` (`egobody` only, so far)."""
    if name != "egobody":
        raise KeyError(f"unknown dataset {name!r}; registered: ['egobody']")
    path = os.path.join(root, "EgoBody")
    if os.path.isdir(path):
        return EgoBodyDataModule(path)
    return SyntheticDataModule(condition, motion_length, scene_points)
