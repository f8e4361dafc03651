"""Action-to-motion datamodules over the real releases
(`seeme_tpu/data/a2m.py:30-290`), numpy and scipy only.

HumanAct12: the `humanact12poses.pkl` release (`mld/data/a2m/humanact12poses.py:14-47`:
per-clip axis-angle poses (T, 72), joints3D (T, 24, 3), labels y), every
clip in every split as the protocol has it. UESTC: the VIBE-preprocessed
release (`mld/data/a2m/uestc.py:57-212`: `info/{names,num_frames_min,action_classes}.txt`
and `vibe_cache_refined.pkl` with per-video poses, 49-joint VIBE joints and
`orig_cam`), with the subject split, the side-2 front-view rotation, the
skipped view 8 of side 2, the VIBE global translation (or
`globtrans_usez.pkl`), strided frame sampling and the 3/4-length filter on
training clips. Both give the 150 features the A2M system consumes: 24
joints of diffusion-layout rot6d (144), the root trajectory from the first
frame (3) and three zeros, `num_frames` long with zero padding and the true
lengths. Under DEBUG each split keeps its first 32 clips, as the JAX
package's loaders cut them (`seeme_tpu/data/a2m.py:76-77`, `:253-257`).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, Optional

import numpy as np
from scipy.spatial.transform import Rotation

from .batch import epoch_indices

HUMANACT12_CLASSES = 12
UESTC_CLASSES = 40
NFEATS = 150


def aa_to_rot6d_diffusion(aa: np.ndarray) -> np.ndarray:
    """(..., J, 3) axis-angle -> (..., J, 6) diffusion-layout rot6d (the
    first two matrix columns, row-major; `compute_mean_std.py:50-56`)."""
    shape = aa.shape[:-1]
    R = Rotation.from_rotvec(aa.reshape(-1, 3).astype(np.float64)).as_matrix()
    return R[:, :, :2].reshape(*shape, 6).astype(np.float32)


def clip_to_features(pose_aa: np.ndarray, joints3d: np.ndarray, num_frames: int) -> tuple:
    """One release clip -> (motion (num_frames, 150), length)."""
    T = min(len(pose_aa), num_frames)
    rot6d = aa_to_rot6d_diffusion(pose_aa[:T].reshape(T, 24, 3)).reshape(T, 144)
    transl = joints3d[:T, 0].astype(np.float32)
    transl = transl - transl[:1]
    feats = np.zeros((num_frames, NFEATS), np.float32)
    feats[:T, :144] = rot6d
    feats[:T, 144:147] = transl
    return feats, np.int32(T)


class A2MSplits:
    """The datamodule interface over `_splits`, a dict of splits, each None
    or a dict of per-sample arrays (`motion`, `action`, `length`); the
    features are not normalized (mean 0, std 1)."""

    is_synthetic = False
    _splits: Dict[str, Optional[Dict[str, np.ndarray]]]

    def _finish(self, name: str, num_classes: int, nfeats: int = NFEATS,
                debug: bool = False) -> None:
        if debug:  # val may be the test split's own dict: each cut once
            cut = {id(v): None if v is None else {k: a[:32] for k, a in v.items()}
                   for v in self._splits.values()}
            self._splits = {k: cut[id(v)] for k, v in self._splits.items()}
        self.name, self.num_classes, self.nfeats = name, num_classes, nfeats
        train = self._splits["train"]
        self.num_train = 0 if train is None else len(train["motion"])
        self.mean = np.zeros(nfeats, np.float32)
        self.std = np.ones(nfeats, np.float32)

    def split_arrays(self, split: str):
        return self._splits[split]

    def batch_indices(self, split: str, batch_size: int, shuffle=None, seed: int = 0,
                      drop_last: bool = True):
        data = self._splits[split]
        if data is None:
            return iter(())
        if shuffle is None:
            shuffle = split == "train"
        return epoch_indices(len(data["motion"]), batch_size, shuffle=shuffle, seed=seed,
                             drop_last=drop_last)

    def batches(self, split: str, batch_size: int, shuffle=None, seed: int = 0,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        data = self._splits[split]
        for sel in self.batch_indices(split, batch_size, shuffle=shuffle, seed=seed,
                                      drop_last=drop_last):
            yield {k: v[sel] for k, v in data.items()}


class HumanAct12DataModule(A2MSplits):
    """Every clip of two frames or more; train, val and test are the same set
    (`humanact12poses.py:31` trains on every index; FID compares generated
    against dataset statistics)."""

    def __init__(self, pkl_path: str, num_frames: int = 60, debug: bool = False):
        with open(pkl_path, "rb") as f:
            data = pickle.load(f)
        feats, lengths, labels = [], [], []
        for pose, joints, y in zip(data["poses"], data["joints3D"], data["y"]):
            if len(pose) < 2:
                continue
            m, L = clip_to_features(np.asarray(pose), np.asarray(joints), num_frames)
            feats.append(m)
            lengths.append(L)
            labels.append(np.int32(y))
        every = {"motion": np.stack(feats), "length": np.asarray(lengths, np.int32),
                 "action": np.asarray(labels, np.int32)}
        self._splits = dict.fromkeys(("train", "val", "test"), every)
        self._finish("humanact12", HUMANACT12_CLASSES, debug=debug)


# Subject split of the release protocol: 51 of 118 subjects train, the rest
# test (`mld/data/a2m/uestc.py:77-87`).
UESTC_TRAIN_SUBJECTS = frozenset([
    1, 2, 6, 12, 13, 16, 21, 24, 28, 29, 30, 31, 33, 35, 39, 41, 42, 45, 47,
    50, 52, 54, 55, 57, 59, 61, 63, 64, 67, 69, 70, 71, 73, 77, 81, 84, 86,
    87, 88, 90, 91, 93, 96, 99, 102, 103, 104, 107, 108, 112, 113,
])

# VIBE 49-joint -> 18 action2motion joints; index 0 (= 8) is the pelvis, the
# root trajectory (`uestc.py:10-12`, `dataset.py:110-114`).
UESTC_A2M_JOINTS = np.array([8, 1, 2, 3, 4, 5, 6, 7, 0, 9, 10, 11, 12, 13, 14, 21, 24, 38])


def _vibe_global_translation(orig_cam: np.ndarray, joints3d: np.ndarray,
                             img_size: float = 540.0, flength: float = 500.0) -> np.ndarray:
    """Per-frame global translation from VIBE's orig_cam [sx, sy, tx, ty]:
    xy from the camera, z from the orthographic / perspective height ratio
    (`mld/data/a2m/uestc.py:15-54`), zeroed at frame 0."""
    out = np.zeros((len(joints3d), 3), np.float64)
    for t in range(len(joints3d)):
        s, pos = orig_cam[t, 0], orig_cam[t, 2:4]
        j = joints3d[t, :, :2]
        target = (s * (j + pos) + 1.0) * 0.5 * img_size
        h3d = np.linalg.norm(j.max(0) - j.min(0))
        h2d = np.linalg.norm(target.max(0) - target.min(0))
        out[t] = [orig_cam[t, 2], orig_cam[t, 3], flength * (h3d / h2d)]
    return (out - out[:1]).astype(np.float32)


def _y_rotation(view: int) -> np.ndarray:
    """Front-view correction: -view * pi / 4 about y (`uestc.py:146-157`)."""
    th = -view * np.pi / 4.0
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float64)


def _strided_frame_ix(nframes: int, num_frames: int) -> np.ndarray:
    """Frames spanning the clip at a fixed stride (the reference's step_max
    branch with shift 0, `dataset.py:195-209`); a clip shorter than
    `num_frames` repeats its last frame (`dataset.py:188-193`)."""
    if nframes >= num_frames:
        step = (nframes - 1) // (num_frames - 1) if num_frames > 1 else 1
        return np.arange(num_frames) * max(step, 1)
    pad = np.full(num_frames - nframes, nframes - 1, dtype=int)
    return np.concatenate([np.arange(nframes), pad])


class UestcDataModule(A2MSplits):
    """The release under `root`, every view, or with `view="frontview"` the
    side-1 videos only (`seeme_tpu/data/a2m.py:172, :208`); the val split is
    the test split."""

    def __init__(self, root: str, num_frames: int = 60, debug: bool = False,
                 view: str = "all"):
        with open(os.path.join(root, "info", "names.txt")) as f:
            videos = f.read().splitlines()
        with open(os.path.join(root, "info", "num_frames_min.txt")) as f:
            nframes_min = np.asarray([int(s) for s in f.read().splitlines()])
        with open(os.path.join(root, "info", "action_classes.txt")) as f:
            self.action_classes = f.read().splitlines()
        with open(os.path.join(root, "vibe_cache_refined.pkl"), "rb") as f:
            vibe = pickle.load(f)
        poses = [np.asarray(p, np.float32) for p in vibe["pose"]]
        joints = [np.asarray(j, np.float32) for j in vibe["joints3d"]]
        nframes = np.minimum(nframes_min, [len(p) for p in poses]).astype(int)
        glob_path = os.path.join(root, "globtrans_usez.pkl")
        if os.path.exists(glob_path):
            with open(glob_path, "rb") as f:
                globtrans = [np.asarray(g, np.float32) for g in pickle.load(f)]
        else:
            globtrans = [_vibe_global_translation(np.asarray(vibe["orig_cam"][i]), joints[i])
                         for i in range(len(poses))]

        rows = {"train": ([], [], []), "test": ([], [], [])}
        min_train_frames = num_frames * 3 / 4  # `uestc.py:198-206`
        for i, name in enumerate(videos):
            # a{action}_d{view}_p{subject}_c{side}_color.avi (`uestc.py:230-242`)
            spl = name.split("_")
            action, vview, subject, side = (int(spl[k][1:]) for k in range(4))
            if view == "frontview" and side != 1:
                continue
            T = int(nframes[i])
            if T < 2:
                continue
            pose, jts, gtr = poses[i][:T].copy(), joints[i][:T].copy(), globtrans[i][:T].copy()
            if side != 1:
                if vview == 8:  # `uestc.py:173-175`
                    continue
                R = _y_rotation(vview)
                g = Rotation.from_rotvec(pose[:, :3].astype(np.float64))
                pose[:, :3] = Rotation.from_matrix(R @ g.as_matrix()).as_rotvec().astype(np.float32)
                jts = (jts @ R.T).astype(np.float32)
                gtr = (gtr @ R.T).astype(np.float32)
            jts = jts + gtr[:, None]  # `uestc.py:187-189`
            root_traj = jts[:, UESTC_A2M_JOINTS[0]]
            ix = _strided_frame_ix(T, num_frames)
            m, L = clip_to_features(pose[ix], root_traj[ix][:, None], num_frames)
            is_train = subject in UESTC_TRAIN_SUBJECTS
            if is_train and T < min_train_frames:
                continue
            for out, v in zip(rows["train" if is_train else "test"], (m, L, np.int32(action))):
                out.append(v)

        def pack(feats, lens, labs):
            if not feats:
                return None
            return {"motion": np.stack(feats), "length": np.asarray(lens, np.int32),
                    "action": np.asarray(labs, np.int32)}

        self._splits = {k: pack(*v) for k, v in rows.items()}
        self._splits["val"] = self._splits["test"]
        self._finish("uestc", UESTC_CLASSES, debug=debug)
