"""Dataset name -> datamodule (`seeme_tpu/data/registry.py:34-138`).

EgoBody and GIMO load the preprocessed release (`data/egobody.py`) when
`<root>/EgoBody` or `<root>/GIMO` exists; otherwise `SyntheticDataModule`
keeps the path runnable, as the JAX package does (256 train, 64 val and 64
test samples from seeds 0, 1 and 2, 32 / 16 / 16 under DEBUG; GIMO's 66
pose features, and its val split the test split, as `dataset.py:1840-1842`
aliases them). HumanML3D
and KIT read `<root>/HumanML3D` or `<root>/KIT-ML` through
`data/humanml.py::HumanML3DDataModule`, which falls back to its synthetic
splits when the folder is not there. HumanAct12 reads
`<root>/HumanAct12Poses/humanact12poses.pkl` and UESTC
`<root>/uestc/vibe_cache_refined.pkl` through `data/a2m.py` when they are
there; otherwise `SyntheticA2MDataModule` (12 or 40 classes, 150
features), draw for draw the JAX package's (`seeme_tpu/data/registry.py:141-222`).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from .a2m import (
    HUMANACT12_CLASSES,
    UESTC_CLASSES,
    A2MSplits,
    HumanAct12DataModule,
    UestcDataModule,
)
from .egobody import EgoBodyDataModule
from .humanml import HUMANML_NFEATS, KIT_NFEATS, MIN_LEN, HumanML3DDataModule
from .synthetic import SyntheticEgoDataset


class SyntheticDataModule:
    """Per-split `SyntheticEgoDataset`s with the datamodule interface."""

    def __init__(self, condition: Sequence[str] = (), motion_length: int = 60,
                 scene_points: int = 1024, name: str = "egobody", image_size: int = 224,
                 debug: bool = False):
        with_scene = "scene" in condition
        num_train, num_eval = (32, 16) if debug else (256, 64)
        pose_feats = 72 if name == "egobody" else 66
        common = dict(motion_length=motion_length, pose_feats=pose_feats,
                      scene_points=max(scene_points if with_scene else 0, 1),
                      with_scene=with_scene, with_image="image" in condition,
                      image_size=image_size)
        self.train_set = SyntheticEgoDataset(num_train, seed=0, **common)
        self.val_set = SyntheticEgoDataset(num_eval, seed=1, **common)
        self.test_set = SyntheticEgoDataset(num_eval, seed=2, **common)
        self.mean = self.train_set.mean
        self.std = self.train_set.std
        self.num_train = len(self.train_set)
        self.nfeats = pose_feats + 3
        self.name = name
        self.is_synthetic = True

    def _split(self, split: str) -> SyntheticEgoDataset:
        if split == "val" and self.name == "gimo":
            split = "test"
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
        batch then carries: the stage-2 cache of frozen scene or image
        features."""
        ds = self._split(split)
        if len(values) != len(ds):
            raise ValueError(f"{key}: {len(values)} rows for a split of {len(ds)}")
        ds.extras[key] = np.asarray(values)


class SyntheticA2MDataModule(A2MSplits):
    """HumanAct12- / UESTC-shaped action-to-motion data: 240 train, 60 val
    and 60 test samples (48 / 12 / 12 under DEBUG), class-signature offsets
    shared by every split over a cumulative random walk, each clip
    `num_frames` long."""

    is_synthetic = True

    def __init__(self, num_classes: int = 12, nfeats: int = 150, num_frames: int = 60,
                 name: str = "humanact12", debug: bool = False):
        rng = np.random.RandomState(0)
        n = 48 if debug else 240
        base = rng.randn(num_classes, 1, nfeats).astype(np.float32)

        def make(n_samples, seed):
            r = np.random.RandomState(seed)
            labels = r.randint(0, num_classes, n_samples)
            motion = np.cumsum(
                r.randn(n_samples, num_frames, nfeats).astype(np.float32) * 0.02,
                axis=1) + base[labels]
            return {"motion": motion, "action": labels.astype(np.int32),
                    "length": np.full(n_samples, num_frames, np.int32)}

        self._splits = {"train": make(n, 0), "val": make(n // 4, 1), "test": make(n // 4, 2)}
        self._finish(name, num_classes, nfeats)


RELEASES = {"egobody": ("EgoBody", 72), "gimo": ("GIMO", 66)}  # name -> (folder, pose feats)
T2M_RELEASES = {"humanml3d": ("HumanML3D", HUMANML_NFEATS), "kit": ("KIT-ML", KIT_NFEATS)}
A2M_CLASSES = {"humanact12": HUMANACT12_CLASSES, "uestc": UESTC_CLASSES}


def get_datamodule(name: str, condition: Sequence[str] = (), motion_length: int = 60,
                   scene_points: int = 1024, root: str = "./datasets", image_size: int = 224,
                   text_dim: int = 768, min_len: int = MIN_LEN, debug: bool = False):
    """The datamodule of DATASET_NAME `name`: its release under `root` when
    it is there, else the synthetic data (`image_size` sizes its crops; a
    text-to-motion set takes clips of `min_len` to `motion_length` frames
    and makes its synthetic text embeddings `text_dim` wide; an
    action-to-motion set's clips are `motion_length` frames). `debug` (the
    config's DEBUG) cuts every set as the JAX package does: the synthetic
    splits are made small, and a release's splits are cut to their first 10
    (EgoBody, GIMO) or 32 (HumanAct12, UESTC) rows."""
    if name == "humanact12":
        path = os.path.join(root, "HumanAct12Poses", "humanact12poses.pkl")
        if os.path.exists(path):
            return HumanAct12DataModule(path, num_frames=motion_length, debug=debug)
    if name == "uestc":
        path = os.path.join(root, "uestc")
        if os.path.exists(os.path.join(path, "vibe_cache_refined.pkl")):
            return UestcDataModule(path, num_frames=motion_length, debug=debug)
    if name in A2M_CLASSES:
        return SyntheticA2MDataModule(A2M_CLASSES[name], num_frames=motion_length, name=name,
                                      debug=debug)
    if name in T2M_RELEASES:
        folder, nfeats = T2M_RELEASES[name]
        path = os.path.join(root, folder)
        return HumanML3DDataModule(path if os.path.isdir(path) else None, nfeats,
                                   max_len=motion_length, min_len=min_len, text_dim=text_dim,
                                   num_train=32 if debug else 256)
    if name not in RELEASES:
        raise KeyError(f"unknown dataset {name!r}; registered: "
                       f"{sorted({**RELEASES, **T2M_RELEASES, **A2M_CLASSES})}")
    folder, pose_feats = RELEASES[name]
    path = os.path.join(root, folder)
    if os.path.isdir(path):
        return EgoBodyDataModule(path, pose_feats=pose_feats, debug=debug)
    return SyntheticDataModule(condition, motion_length, scene_points, name, image_size, debug)
