"""EgoHMR scene preprocessing, stages s1 and s2 (`tools/preprocess_scene_egohmr.py`,
the reference's `EgoHMR/preprocess_scene_s1.py:1-140` and
`preprocess_scene_s2_for_{train,test}.py`, without open3d or pandas).

    python -m seeme_tpu_torch.tools.preprocess_scene_egohmr --stage s1|s2
        --data_root DIR --save_root DIR [--split train]
        [--scene_verts_num_target 20000] [--cube_size 2.0]
        [--smpl_path ./deps/smpl_models/smpl/SMPL_NEUTRAL.pkl] [--seed 0]
        [--device cpu | --cpu]

s1: per egocentric frame, the scene mesh's vertices go scene -> master
kinect -> HoloLens -> PV camera (and the OpenGL axis flip); the vertices in
front of the camera are kept, uniformly downsampled to the target count and
taken back to the kinect frame; `map_dict_{split}.pkl` and
`pcd_verts_dict_{split}.pkl` are written (a point cloud every 15 frames, as
`preprocess_scene_s1.py:74-78`).

s2: a `cube_size` cube of scene around the ground-truth body (a random yaw
about the body's centre and a bounded random shift in training, the height
cut at `cube_size` above the crop's floor), downsampled and rotated back,
one npy a frame (`preprocess_scene_s2_for_train.py:135-200`). The body is
`smpl_forward` of the SMPL file at `--smpl_path` (the synthetic body when it
is absent, as the root tool falls back) on the card unless `--device cpu`.
The random draws come from one `numpy.random.RandomState(--seed)`, in the
root tool's order, so both write the same crops.

The geometric cores are numpy functions of their arrays, the root tool's
(`:41-127`); `run_s1` / `run_s2` need the EgoBody release's layout
(`data_info_release.csv`, `smpl_spin_npz/`, `transf_matrices_all_seqs.pkl`,
`scene_mesh/`, `calibrations/`).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import pickle
import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..core.smpl import smpl_body, smpl_forward

# the egocentric camera is OpenGL-coordinate, the kinect OpenCV
# (`preprocess_scene_s1.py:53-57`)
ADD_TRANS = np.array([[1.0, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]])


def load_obj_vertices(path: str) -> np.ndarray:
    """The `v x y z` lines of an OBJ file."""
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(verts, np.float64)


def apply_transform(verts: np.ndarray, T: np.ndarray) -> np.ndarray:
    """(N, 3) through a homogeneous 4x4."""
    return verts @ T[:3, :3].T + T[:3, 3]


def front_crop(verts: np.ndarray) -> np.ndarray:
    """The vertices in front of the egocentric camera (z > 0 after the
    OpenGL flip, `preprocess_scene_s1.py:100-103`)."""
    return verts[verts[:, 2] > 0]


def uniform_downsample(verts: np.ndarray, target: int) -> np.ndarray:
    """open3d's `uniform_down_sample(every_k_points=n // target)`, capped at
    `target` (`preprocess_scene_s1.py:106-114`); tiled when short, so the
    output is always (target, 3)."""
    n = len(verts)
    if n == 0:
        return np.zeros((target, 3), np.float64)
    out = verts[::max(int(n / target), 1)]
    if len(out) < target:
        out = out[np.resize(np.arange(len(out)), target)]
    return out[:target]


def _rot_xz(verts: np.ndarray, center: np.ndarray, angle: float) -> np.ndarray:
    """Rotation about the vertical (y) axis through `center`
    (`preprocess_scene_s2_for_train.py:140-151`)."""
    out = verts.copy()
    dx = verts[:, 0] - center[0]
    dz = verts[:, 2] - center[2]
    out[:, 0] = dx * np.cos(angle) - dz * np.sin(angle) + center[0]
    out[:, 2] = dx * np.sin(angle) + dz * np.cos(angle) + center[2]
    return out


def crop_scene_cube_around_body(scene_verts: np.ndarray, body_verts: np.ndarray,
                                cube_size: float = 2.0, target: int = 20000,
                                rng: Optional[np.random.RandomState] = None,
                                augment: bool = True) -> Tuple[np.ndarray, float, np.ndarray]:
    """The s2 crop (`preprocess_scene_s2_for_train.py:135-190`) of (N, 3)
    scene vertices around (V, 3) body vertices in one frame (y up): a random
    yaw about the body's centre, a random XZ shift that keeps the body in
    the cube, the crop, the height cut, the downsample, the yaw undone.
    Returns (verts (target, 3), angle, shift)."""
    rng = rng or np.random.RandomState(0)
    center = body_verts.mean(axis=0)
    angle = rng.uniform(0, 2 * np.pi) if augment else 0.0
    scene_aug = _rot_xz(scene_verts, center, angle)
    body_aug = _rot_xz(body_verts, center, angle)

    shift = np.zeros(3)
    if augment:
        bmin, bmax = body_aug.min(0), body_aug.max(0)
        shift[0] = rng.uniform(max(-cube_size / 4, (bmax[0] - center[0]) - cube_size / 2),
                               min(cube_size / 4, cube_size / 2 - (center[0] - bmin[0])))
        shift[2] = rng.uniform(max(-cube_size / 4, (bmax[2] - center[2]) - cube_size / 2),
                               min(cube_size / 4, cube_size / 2 - (center[2] - bmin[2])))

    lo_x, hi_x = center[0] - cube_size / 2 + shift[0], center[0] + cube_size / 2 + shift[0]
    lo_z, hi_z = center[2] - cube_size / 2 + shift[2], center[2] + cube_size / 2 + shift[2]
    crop = scene_aug[(scene_aug[:, 0] >= lo_x) & (scene_aug[:, 0] <= hi_x)
                     & (scene_aug[:, 2] >= lo_z) & (scene_aug[:, 2] <= hi_z)]
    if len(crop):
        crop = crop[crop[:, 1] <= crop[:, 1].min() + cube_size]
    return _rot_xz(uniform_downsample(crop, target), center, -angle), angle, shift


# ---- the release's tables

def _scene_of(data_root: str) -> Dict[str, str]:
    """recording_name -> scene_name of `data_info_release.csv`."""
    with open(os.path.join(data_root, "data_info_release.csv"), newline="") as f:
        return {row["recording_name"]: row["scene_name"] for row in csv.DictReader(f)}


def _release(data_root: str, split: str):
    data = np.load(os.path.join(data_root, f"smpl_spin_npz/egocapture_{split}_smpl.npz"))
    with open(os.path.join(data_root, "transf_matrices_all_seqs.pkl"), "rb") as f:
        transf = pickle.load(f)  # the release's own file
    return _scene_of(data_root), data, transf


def _frame_transforms(data_root: str, transf: Dict, imgname: str, rec: str, seq: str,
                      scene: str):
    """(kinect -> holo, world -> PV, scene -> master kinect) of one frame."""
    t_seq = transf[seq] if seq in transf else transf[rec]
    k2h = np.asarray(t_seq["trans_kinect2holo"], np.float64)
    h2pv = np.asarray(t_seq["trans_world2pv"][imgname.split("/")[-1][-15:-4]], np.float64)
    with open(os.path.join(data_root, "calibrations", rec, "cal_trans/kinect12_to_world",
                           f"{scene}.json")) as f:
        scene2main = np.linalg.inv(np.asarray(json.load(f)["trans"]))
    return k2h, h2pv, scene2main


def _scene_mesh(cache: Dict, data_root: str, scene: str) -> np.ndarray:
    if scene not in cache:
        cache[scene] = load_obj_vertices(os.path.join(data_root, "scene_mesh", scene,
                                                      f"{scene}.obj"))
    return cache[scene]


def run_s1(data_root: str, save_root: str, split: str, target: int = 20000,
           cache_every: int = 15) -> Dict:
    scene_of, data, transf = _release(data_root, split)
    os.makedirs(save_root, exist_ok=True)
    mesh_cache: Dict = {}
    map_dict, pcd_dict = {}, {}
    last_scene, last_key = "", None
    for cnt, imgname in enumerate(data["imgname"]):
        rec, seq = imgname.split("/")[-4], imgname.split("/")[-3]
        scene = scene_of[rec]
        key = "/".join(imgname.split("/")[-5:]) if imgname.startswith("/") else imgname
        if cnt % cache_every == 0 or last_scene != scene:
            k2h, h2pv, scene2main = _frame_transforms(data_root, transf, imgname, rec, seq, scene)
            v = _scene_mesh(mesh_cache, data_root, scene)
            for T in (scene2main, k2h, h2pv, ADD_TRANS):
                v = apply_transform(v, T)
            v = uniform_downsample(front_crop(v), target)
            # back to the kinect master frame (`preprocess_scene_s1.py:116-119`)
            for T in (ADD_TRANS, h2pv, k2h):
                v = apply_transform(v, np.linalg.inv(T))
            pcd_dict[key] = v
            last_key = key
        map_dict[key] = last_key
        last_scene = scene
    with open(os.path.join(save_root, f"map_dict_{split}.pkl"), "wb") as f:
        pickle.dump(map_dict, f, protocol=2)
    with open(os.path.join(save_root, f"pcd_verts_dict_{split}.pkl"), "wb") as f:
        pickle.dump(pcd_dict, f, protocol=2)
    print(f"s1 {split}: {len(pcd_dict)} cached pcds for {len(map_dict)} frames")
    return {"pcds": len(pcd_dict), "frames": len(map_dict)}


def run_s2(data_root: str, save_root: str, split: str, target: int = 20000,
           cube_size: float = 2.0, smpl_path: str = "", seed: int = 0,
           device: str | torch.device = "cuda") -> Dict:
    dev = resolve_device(device)
    smpl = smpl_body(smpl_path if smpl_path and os.path.exists(smpl_path) else "", dev)
    scene_of, data, transf = _release(data_root, split)
    rng = np.random.RandomState(seed)
    mesh_cache: Dict = {}
    n_done = 0

    def row(key, i, cols=None):
        a = data[key][[i]] if cols is None else data[key][[i], cols]
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    for i, imgname in enumerate(data["imgname"]):
        rec, seq = imgname.split("/")[-4], imgname.split("/")[-3]
        frame = imgname.split("/")[-1][:-4]
        scene = scene_of[rec]
        mesh = _scene_mesh(mesh_cache, data_root, scene)
        k2h, h2pv, scene2main = _frame_transforms(data_root, transf, imgname, rec, seq, scene)
        # the ground-truth body in the PV frame -> the scene frame
        with torch.no_grad():
            fk = smpl_forward(smpl, row("shape", i, slice(0, 10)), row("pose", i, slice(3, 72)),
                              row("global_orient_pv", i), row("transl_pv", i))
        body = fk["vertices"][0].cpu().numpy().astype(np.float64)
        for T in (ADD_TRANS, h2pv, k2h, scene2main):
            body = apply_transform(body, np.linalg.inv(T))
        verts, _, _ = crop_scene_cube_around_body(mesh, body, cube_size=cube_size,
                                                  target=target, rng=rng,
                                                  augment=split == "train")
        out_dir = os.path.join(save_root, split, rec, seq)
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, f"{frame}.npy"), verts.astype(np.float32))
        n_done += 1
    print(f"s2 {split}: wrote {n_done} cropped scene npys")
    return {"written": n_done}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.tools.preprocess_scene_egohmr")
    ap.add_argument("--stage", choices=["s1", "s2"], required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--save_root", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--scene_verts_num_target", type=int, default=20000)
    ap.add_argument("--cube_size", type=float, default=2.0)
    ap.add_argument("--smpl_path", default="./deps/smpl_models/smpl/SMPL_NEUTRAL.pkl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    if args.stage == "s1":
        return run_s1(args.data_root, args.save_root, args.split, args.scene_verts_num_target)
    return run_s2(args.data_root, args.save_root, args.split, args.scene_verts_num_target,
                  args.cube_size, args.smpl_path, args.seed,
                  "cpu" if args.cpu else args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
