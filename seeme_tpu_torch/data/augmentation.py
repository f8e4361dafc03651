"""EgoHMR-branch training augmentation, host-side numpy: the port's own copy
of `seeme_tpu/data/augmentation.py`, draw for draw.

The crop / scale / rotate / flip / colour pipeline of
`EgoHMR/dataloaders/augmentation.py:14-536` that feeds ProHMR-Scene and
EgoHMR training, on the fixed-shape examples of `data/egohmr_images.py`
(crop-space keypoints in [-0.5, 0.5]), and the CMU `MoCapDataset`
(`EgoHMR/dataloaders/mocap_dataset.py:5-26`) whose unpaired poses are the
discriminator's real ones. Draws come from an explicit
`np.random.RandomState`; the patch warp is cv2's `warpAffine` where cv2
imports and scipy's `affine_transform` otherwise, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

# SMPL 24-joint left/right swap (`egobody_dataset.py:98-123`)
FLIP_3D_PERM = np.array([0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13,
                         15, 17, 16, 19, 18, 21, 20, 23, 22])
# OpenPose-25 left/right swap (`egobody_dataset.py:71-97`)
FLIP_2D_PERM = np.array([0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11,
                         16, 15, 18, 17, 22, 23, 24, 19, 20, 21])
# axis-angle per-joint left/right swap of the 23-joint body pose
# (`augmentation.py:196-203` body_pose_permutation, already 0-based per xyz)
_BP_PERM = np.array([6, 7, 8, 3, 4, 5, 9, 10, 11, 15, 16, 17, 12, 13, 14,
                     18, 19, 20, 24, 25, 26, 21, 22, 23, 27, 28, 29, 33, 34,
                     35, 30, 31, 32, 36, 37, 38, 42, 43, 44, 39, 40, 41, 45,
                     46, 47, 51, 52, 53, 48, 49, 50, 57, 58, 59, 54, 55, 56,
                     63, 64, 65, 60, 61, 62, 69, 70, 71, 66, 67, 68]) - 3


@dataclass(frozen=True)
class AugmentConfig:
    """`EgoHMR/configs/__init__.py:24-31` defaults."""

    scale_factor: float = 0.3
    rot_factor: float = 30.0
    trans_factor: float = 0.02
    color_scale: float = 0.2
    rot_aug_rate: float = 0.6
    do_flip: bool = True
    flip_aug_rate: float = 0.5


def sample_augmentation(rng: np.random.RandomState, cfg: AugmentConfig) -> Tuple:
    """Random augmentation parameters (`do_augmentation`, :14-38)."""
    tx = np.clip(rng.randn(), -1.0, 1.0) * cfg.trans_factor
    ty = np.clip(rng.randn(), -1.0, 1.0) * cfg.trans_factor
    scale = np.clip(rng.randn(), -1.0, 1.0) * cfg.scale_factor + 1.0
    rot = (np.clip(rng.randn(), -2.0, 2.0) * cfg.rot_factor
           if rng.rand() <= cfg.rot_aug_rate else 0.0)
    do_flip = bool(cfg.do_flip and rng.rand() <= cfg.flip_aug_rate)
    lo, hi = 1.0 - cfg.color_scale, 1.0 + cfg.color_scale
    color = rng.uniform(lo, hi, size=3)
    return scale, rot, do_flip, color, tx, ty


# ------------------------------------------------------------- image warping

def gen_trans_from_patch(c_x, c_y, src_w, src_h, dst_w, dst_h, scale, rot):
    """Affine matrix mapping the (scaled, rotated) source box onto the patch
    (`gen_trans_from_patch_cv`, :57-105) — solved directly instead of
    cv2.getAffineTransform."""
    rot_rad = np.pi * rot / 180.0
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)

    def rot2d(p):
        return np.array([p[0] * cs - p[1] * sn, p[0] * sn + p[1] * cs])

    src_c = np.array([c_x, c_y], np.float64)
    src_down = rot2d([0, src_h * scale * 0.5])
    src_right = rot2d([src_w * scale * 0.5, 0])
    dst_c = np.array([dst_w * 0.5, dst_h * 0.5])
    src = np.stack([src_c, src_c + src_down, src_c + src_right])
    dst = np.stack([dst_c, dst_c + np.array([0, dst_h * 0.5]),
                    dst_c + np.array([dst_w * 0.5, 0])])
    # solve [x y 1] @ A.T = dst  for the 2x3 affine A
    ones = np.concatenate([src, np.ones((3, 1))], axis=1)
    return np.linalg.solve(ones, dst).T  # (2, 3)


def trans_point2d(pts: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """(N, 2) points through a 2x3 affine (`trans_point2d`, :107-119)."""
    return pts @ trans[:, :2].T + trans[:, 2]


def warp_affine(img: np.ndarray, trans: np.ndarray, out_w: int, out_h: int):
    """cv2.warpAffine equivalent; scipy inverse-mapping fallback."""
    try:
        import cv2

        return cv2.warpAffine(img, trans[:2].astype(np.float64),
                              (out_w, out_h), flags=cv2.INTER_LINEAR)
    except ImportError:
        from scipy.ndimage import affine_transform

        full = np.eye(3)
        full[:2] = trans
        inv = np.linalg.inv(full)
        out = np.empty((out_h, out_w, img.shape[2]), img.dtype)
        # scipy maps output->input with (row, col) ordering
        mat = np.array([[inv[1, 1], inv[1, 0]], [inv[0, 1], inv[0, 0]]])
        off = np.array([inv[1, 2], inv[0, 2]])
        for c in range(img.shape[2]):
            out[..., c] = affine_transform(
                img[..., c], mat, offset=off, output_shape=(out_h, out_w),
                order=1, mode="constant")
        return out


def generate_image_patch(img, c_x, c_y, bb_w, bb_h, patch_w, patch_h,
                         do_flip, scale, rot):
    """Crop + augment one patch (`generate_image_patch`, :121-150)."""
    h, w = img.shape[:2]
    if do_flip:
        img = img[:, ::-1]
        c_x = w - c_x - 1
    trans = gen_trans_from_patch(c_x, c_y, bb_w, bb_h, patch_w, patch_h,
                                 scale, rot)
    return warp_affine(np.ascontiguousarray(img), trans, patch_w, patch_h), trans


# ------------------------------------------------------ parameter transforms

def rot_aa(aa: np.ndarray, rot: float) -> np.ndarray:
    """Rotate an axis-angle vector by `rot` degrees about the camera z axis
    (`rot_aa`, :292-310)."""
    from scipy.spatial.transform import Rotation

    rad = np.deg2rad(-rot)
    R = np.array([[np.cos(rad), -np.sin(rad), 0],
                  [np.sin(rad), np.cos(rad), 0], [0, 0, 1]])
    body = Rotation.from_rotvec(np.asarray(aa, np.float64)).as_matrix()
    return Rotation.from_matrix(R @ body).as_rotvec().astype(np.float32)


def fliplr_params(smpl_params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Left/right-swap SMPL parameters (`fliplr_params`, :168-218)."""
    go = smpl_params["global_orient"].reshape(3).copy()
    bp = smpl_params["body_pose"].reshape(-1).copy()
    bp = bp[_BP_PERM[: len(bp)]]
    go[1:] *= -1
    bp[1::3] *= -1
    bp[2::3] *= -1
    return {
        "global_orient": go.astype(np.float32),
        "body_pose": bp.astype(np.float32),
        "betas": np.asarray(smpl_params["betas"], np.float32),
        "transl": np.asarray(smpl_params["transl"], np.float32),
    }


def _z_rotation(rot: float) -> np.ndarray:
    m = np.eye(3)
    if rot != 0:
        rad = -rot * np.pi / 180.0
        sn, cs = np.sin(rad), np.cos(rad)
        m[0, :2] = [cs, -sn]
        m[1, :2] = [sn, cs]
    return m


def keypoint_3d_processing(kp3d, rot, do_flip, perm=FLIP_3D_PERM):
    """Flip-permute then rotate 3D keypoints about the camera z axis
    (`keypoint_3d_processing`, :237-261)."""
    kp3d = np.asarray(kp3d, np.float64)
    if do_flip:
        kp3d = kp3d[perm].copy()
        kp3d[:, 0] *= -1
    return np.einsum("ij,kj->ki", _z_rotation(rot), kp3d).astype(np.float32)


def scene_verts_3d_processing(verts, rot, do_flip):
    """Same for scene point clouds (`scene_verts_3d_processing`, :264-289)."""
    verts = np.asarray(verts, np.float64).copy()
    if do_flip:
        verts[:, 0] *= -1
    return np.einsum("ij,kj->ki", _z_rotation(rot), verts).astype(np.float32)


# --------------------------------------------------------------- batch-level

def augment_example(ex: Dict[str, np.ndarray], rng: np.random.RandomState,
                    cfg: Optional[AugmentConfig] = None,
                    pelvis_fn=None) -> Dict[str, np.ndarray]:
    """Augment one fixed-shape example from `data/egohmr_images.py`.

    Keypoints are stored in normalized crop coordinates [-0.5, 0.5]; flip and
    rotation act about the crop center, matching `get_example`'s composition
    of crop-space transforms (:395-470). `pelvis_fn(body_pose, betas,
    global_orient) -> (3,)` recomputes the SMPL transl after augmentation
    like the reference's gendered-SMPL pelvis correction (:466-472); when
    None the translation keeps the flipped/rotated 3D-keypoint semantics.
    """
    cfg = cfg or AugmentConfig()
    scale, rot, do_flip, color, tx, ty = sample_augmentation(rng, cfg)
    out = dict(ex)

    # image crop: flip, rotate about center, rescale (tx/ty shift the crop)
    img = np.asarray(ex["img"], np.float32)
    H, W = img.shape[:2]
    cx, cy = W * (0.5 + tx), H * (0.5 + ty)
    patch, _ = generate_image_patch(img, cx, cy, W, H, W, H, do_flip, scale, rot)
    out["img"] = (patch * color[None, None, :]).astype(np.float32)

    # 2D keypoints (normalized crop coords, confidence in the last column)
    kp2d = np.asarray(ex["keypoints_2d"], np.float32).copy()
    if do_flip:
        kp2d = kp2d[FLIP_2D_PERM[: len(kp2d)]].copy()
        kp2d[:, 0] *= -1
    rad = -rot * np.pi / 180.0
    sn, cs = np.sin(rad), np.cos(rad)
    xy = kp2d[:, :2] @ np.array([[cs, sn], [-sn, cs]], np.float32).T / scale
    kp2d[:, :2] = xy - np.array([tx, ty], np.float32)
    inside = (np.abs(kp2d[:, 0]) <= 0.5) & (np.abs(kp2d[:, 1]) <= 0.5)
    kp2d[:, -1] = kp2d[:, -1] * inside
    out["keypoints_2d"] = kp2d

    # 3D keypoints + scene (crop-camera frame)
    for key in ("keypoints_3d", "keypoints_3d_full"):
        if key in ex:
            kp = np.asarray(ex[key], np.float32)
            conf = kp[:, 3:] if kp.shape[1] > 3 else None
            kp3 = keypoint_3d_processing(kp[:, :3], rot, do_flip)
            out[key] = kp3 if conf is None else np.concatenate([kp3, conf], 1)
    if "scene_pcd" in ex:
        out["scene_pcd"] = scene_verts_3d_processing(ex["scene_pcd"], rot, do_flip)

    # SMPL params: flip permutation + global-orient z rotation (:312-327)
    params = {
        "global_orient": np.asarray(ex["global_orient"], np.float32),
        "body_pose": np.asarray(ex["body_pose"], np.float32),
        "betas": np.asarray(ex["betas"], np.float32),
        "transl": np.asarray(ex["transl"], np.float32),
    }
    if do_flip:
        params = fliplr_params(params)
    params["global_orient"] = rot_aa(params["global_orient"], rot)
    if pelvis_fn is not None and "keypoints_3d_full" in out:
        # transl = augmented full-frame pelvis - local pelvis (:466-472)
        local_pelvis = pelvis_fn(params["body_pose"], params["betas"],
                                 params["global_orient"])
        params["transl"] = (out["keypoints_3d_full"][0, :3]
                            - np.asarray(local_pelvis, np.float32))
    else:
        tr = params["transl"].copy()
        if do_flip:
            tr[0] *= -1
        params["transl"] = _z_rotation(rot).astype(np.float32) @ tr
    for k, v in params.items():
        out[k] = v
    return out


def augment_batch(batch: Dict[str, np.ndarray], rng: np.random.RandomState,
                  cfg: Optional[AugmentConfig] = None) -> Dict[str, np.ndarray]:
    """Augment a stacked flat batch (pre-`to_model_batch` schema)."""
    n = len(batch["img"])
    outs = [augment_example({k: v[i] for k, v in batch.items()}, rng, cfg)
            for i in range(n)]
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


# -------------------------------------------------------------------- mocap

class MoCapDataset:
    """Unpaired CMU-MoCap SMPL poses for the discriminator
    (`mocap_dataset.py:5-26`): npz with body_pose (first 3 dims dropped) and
    betas. Synthetic fallback keeps the adversarial path runnable without
    the asset."""

    def __init__(self, dataset_file: Optional[str] = None,
                 synthetic_size: int = 512, seed: int = 0):
        import os

        if dataset_file and os.path.exists(dataset_file):
            data = np.load(dataset_file)
            self.pose = data["body_pose"].astype(np.float32)[:, 3:]
            self.betas = data["betas"].astype(np.float32)
            self.is_synthetic = False
        else:
            rng = np.random.RandomState(seed)
            self.pose = (rng.randn(synthetic_size, 69) * 0.25).astype(np.float32)
            self.betas = (rng.randn(synthetic_size, 10) * 0.6).astype(np.float32)
            self.is_synthetic = True

    def __len__(self) -> int:
        return len(self.pose)

    def batches(self, batch_size: int, rng: np.random.RandomState):
        """Endless shuffled batches (the reference re-iterates its dataloader
        when exhausted, `train_prohmr_scene.py:122-126`)."""
        while True:
            idx = rng.permutation(len(self.pose))
            for i in range(0, len(idx) - batch_size + 1, batch_size):
                sel = idx[i: i + batch_size]
                yield {"body_pose": self.pose[sel], "betas": self.betas[sel]}
