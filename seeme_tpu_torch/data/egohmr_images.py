"""Per-image examples of the standalone ProHMR-Scene / EgoHMR branches
(`seeme_tpu/data/egohmr_images.py`), numpy only.

An example is a crop (H, W, 3), 2D / 3D keypoints, SMPL parameters, camera
intrinsics and the scene point cloud (the reference's key list,
`egobody_dataset.py:303-437`). The splits here are synthetic: with an SMPL
model they are correlated (keypoints, crops and scene follow the ground-truth
pose through FK and projection, draw for draw as the JAX package makes
them), without one independent draws. With `root/processed_images/` present
the splits are its `{train,val,test}.npz` files, made offline from the
release with these keys. `batches(augment=True)` runs the training
augmentation (`data/augmentation.py`).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator

import numpy as np
import torch

from ..core.smpl import smpl_forward
from .augmentation import augment_batch

# SMPL-45 -> OpenPose-25 joints (`prohmr_scene.py:67-68`)
SMPL_TO_OPENPOSE = np.array(
    [24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
     25, 26, 27, 28, 29, 30, 31, 32, 33, 34])
SIZES = {"train": 64, "val": 16, "test": 16}
SPLIT_SEEDS = {"train": 0, "val": 1, "test": 2}


def synthetic_image_example(rng: np.random.RandomState, n_pts: int = 1024,
                            img_size: int = 224) -> Dict[str, np.ndarray]:
    """One uncorrelated example (`seeme_tpu/data/egohmr_images.py:19`)."""
    pose = rng.randn(69).astype(np.float32) * 0.3
    go = rng.randn(3).astype(np.float32) * 0.3
    kp2d = rng.randn(25, 3).astype(np.float32)
    kp2d[:, 2] = (rng.rand(25) > 0.2).astype(np.float32)
    return {
        "img": rng.rand(img_size, img_size, 3).astype(np.float32),
        "scene_pcd": rng.randn(n_pts, 3).astype(np.float32),
        "fx": np.float32(1.0),
        "cam_cx": np.float32(960.0),
        "cam_cy": np.float32(540.0),
        "box_center": (rng.rand(2) * 800).astype(np.float32),
        "box_size": np.float32(200.0 + rng.rand() * 100),
        "keypoints_2d": kp2d,
        "orig_keypoints_2d": kp2d.copy(),
        "keypoints_3d": rng.randn(24, 4).astype(np.float32),
        "keypoints_3d_full": rng.randn(24, 4).astype(np.float32),
        "betas": rng.randn(10).astype(np.float32) * 0.5,
        "body_pose": pose,
        "global_orient": go,
        "transl": rng.randn(3).astype(np.float32),
        "gender": np.int32(rng.randint(0, 2)),
    }


class EgoHmrImageDataModule:
    """`seeme_tpu/data/egohmr_images.py:43`: the splits of
    `root/processed_images/{train,val,test}.npz` when that directory exists
    (a missing file is a missing split), else the synthetic train / val /
    test splits (64 / 16 / 16 examples), correlated when `smpl` (a port
    `SmplModel`) is given."""

    def __init__(self, root: str | None = None, n_pts: int = 1024, img_size: int = 224,
                 smpl=None):
        self.n_pts = n_pts
        self.img_size = img_size
        self.smpl = None if smpl is None else smpl.to("cpu")
        self._cache: Dict[str, Dict[str, np.ndarray]] = {}
        proc = os.path.join(root, "processed_images") if root else None
        self.is_synthetic = proc is None or not os.path.isdir(proc)
        if not self.is_synthetic:
            for name in SIZES:
                path = os.path.join(proc, f"{name}.npz")
                if os.path.exists(path):
                    with np.load(path) as f:
                        self._cache[name] = dict(f)

    def split(self, name: str) -> Dict[str, np.ndarray]:
        if not self.is_synthetic:
            return self._cache[name]
        if name not in self._cache:
            rng = np.random.RandomState(SPLIT_SEEDS[name])
            if self.smpl is not None:
                self._cache[name] = self._correlated_split(rng, SIZES[name])
            else:
                examples = [synthetic_image_example(rng, self.n_pts, self.img_size)
                            for _ in range(SIZES[name])]
                self._cache[name] = {k: np.stack([e[k] for e in examples]) for k in examples[0]}
        return self._cache[name]

    def _correlated_split(self, rng: np.random.RandomState, n: int) -> Dict[str, np.ndarray]:
        """Examples consistent with their SMPL parameters
        (`seeme_tpu/data/egohmr_images.py:84-193`): FK keypoints, their
        pinhole projection in OpenPose-25 order with Bernoulli visibility, a
        crop that splats the visible joints, and a scene half hugging the body."""
        S = self.img_size
        body_pose = (rng.randn(n, 69) * 0.3).astype(np.float32)
        global_orient = (rng.randn(n, 3) * 0.3).astype(np.float32)
        betas = (rng.randn(n, 10) * 0.5).astype(np.float32)
        transl = np.stack([rng.randn(n) * 0.3, rng.randn(n) * 0.3, 2.5 + rng.rand(n)],
                          axis=-1).astype(np.float32)
        fx = np.ones(n, np.float32)  # normalized; the focal length is fx * 1500
        cam_cx = np.full(n, 960.0, np.float32)
        cam_cy = np.full(n, 540.0, np.float32)

        with torch.no_grad():
            out = smpl_forward(self.smpl, torch.as_tensor(betas), torch.as_tensor(body_pose),
                               torch.as_tensor(global_orient), return_vertices=False)
        joints45 = out["joints"].numpy().astype(np.float32)
        k3d = joints45[:, :24]
        k3d_full = k3d + transl[:, None]

        pts = joints45 + transl[:, None]
        focal = (fx * 1500.0)[:, None, None]
        px = focal * pts[..., :2] / pts[..., 2:3] + np.stack([cam_cx, cam_cy], axis=-1)[:, None]
        op_px = px[:, SMPL_TO_OPENPOSE]
        op_norm = op_px / np.array([1920.0, 1080.0], np.float32) - 0.5
        conf = (rng.rand(n, 25) > 0.2).astype(np.float32)
        kp2d = np.concatenate([op_norm, conf[..., None]], axis=-1).astype(np.float32)

        lo, hi = op_px.min(axis=1), op_px.max(axis=1)
        box_center = ((lo + hi) / 2).astype(np.float32)
        box_size = ((hi - lo).max(axis=-1) * 1.2 + 1e-3).astype(np.float32)

        yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
        colors = np.stack([(np.arange(25) * 37 % 97) / 97.0, (np.arange(25) * 59 % 83) / 83.0,
                           (np.arange(25) * 17 % 71) / 71.0], axis=-1).astype(np.float32)
        sigma = S / 32.0
        imgs = np.zeros((n, S, S, 3), np.float32)
        for i in range(n):
            tl = box_center[i] - box_size[i] / 2
            crop_xy = (op_px[i] - tl) / box_size[i] * S
            d2 = ((xx[None] - crop_xy[:, 0, None, None]) ** 2
                  + (yy[None] - crop_xy[:, 1, None, None]) ** 2)
            blob = np.exp(-d2 / (2 * sigma**2)) * conf[i][:, None, None]
            imgs[i] = np.einsum("jhw,jc->hwc", blob, colors).clip(0, 1)

        n_body = self.n_pts // 2
        sel = rng.randint(0, 24, (n, n_body))
        body_pts = (k3d_full[np.arange(n)[:, None], sel]
                    + rng.randn(n, n_body, 3).astype(np.float32) * 0.05)
        bg = (rng.randn(n, self.n_pts - n_body, 3) * 1.5 + transl[:, None]).astype(np.float32)
        ones = np.ones((n, 24, 1), np.float32)
        return {
            "img": imgs,
            "scene_pcd": np.concatenate([body_pts, bg], axis=1).astype(np.float32),
            "fx": fx,
            "cam_cx": cam_cx,
            "cam_cy": cam_cy,
            "box_center": box_center,
            "box_size": box_size,
            "keypoints_2d": kp2d,
            "orig_keypoints_2d": kp2d.copy(),
            "keypoints_3d": np.concatenate([k3d, ones], axis=-1),
            "keypoints_3d_full": np.concatenate([k3d_full, ones], axis=-1),
            "betas": betas,
            "body_pose": body_pose,
            "global_orient": global_orient,
            "transl": transl,
            "gender": rng.randint(0, 2, n).astype(np.int32),
        }

    def batches(self, split: str, batch_size: int, shuffle=None, seed: int = 0,
                augment: bool = False, aug_config=None, drop_last: bool = True
                ) -> Iterator[Dict]:
        """Batches of `to_model_batch` in the JAX package's order (shuffled by
        `RandomState(seed)` for the train split unless `shuffle` says);
        `augment` runs `augment_batch` on each with one
        `RandomState(seed + 10007)` for the pass
        (`seeme_tpu/data/egohmr_images.py:185-213`)."""
        data = self.split(split)
        n = len(data["img"])
        idx = np.arange(n)
        if shuffle is None:
            shuffle = split == "train"
        if shuffle:
            np.random.RandomState(seed).shuffle(idx)
        aug_rng = np.random.RandomState(seed + 10_007)
        stop = (n // batch_size) * batch_size if drop_last else n
        for i in range(0, stop, batch_size):
            sel = idx[i: i + batch_size]
            raw = {k: v[sel] for k, v in data.items()}
            if augment:
                raw = augment_batch(raw, aug_rng, aug_config)
            yield to_model_batch(raw)


def to_model_batch(raw: Dict) -> Dict:
    """Flat keys -> the nested batch the models take
    (`seeme_tpu/data/egohmr_images.py:215`)."""
    batch = {k: v for k, v in raw.items()
             if k not in ("betas", "body_pose", "global_orient", "transl", "gender")}
    batch["smpl_params"] = {k: raw[k] for k in ("betas", "body_pose", "global_orient", "transl")}
    batch["gender"] = raw["gender"]
    return batch

