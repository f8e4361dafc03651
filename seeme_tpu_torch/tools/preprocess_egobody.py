"""EgoBody/GIMO preprocessing: reference-layout shards -> fixed-shape npz
(`tools/preprocess_egobody.py`), numpy and scipy; a host tool, no device work.

    python -m seeme_tpu_torch.tools.preprocess_egobody --root datasets/EgoBody
        [--motion-length 60] [--pose-dims 69|63] [--data-type angle|rot6d]
        [--interactee-pred PKL] [--egoego-pred PKL] [--images-root DIR]

Replaces the per-item python work of `EgoBodyData3.__init__/__getitem__`
(`mld/data/humanml/data/dataset.py:1055-1794`) and the reference's
`pre_process_data.py` + `compute_mean_std.py` with a one-shot offline pass:

  input : per-recording `.npy` dicts with the `pre_process_data.py:34-50`
          schema — {video, recording_utils{center, scale, cx, cy, fx, fy,
          frame, original_imgname}, interactee{betas, body_pose,
          global_orient, transl}, wearer{...}} — split into
          {root}/raw/{train,val,test}/ directories, plus optional
          scene point-cloud pkls.
  output: {root}/processed/{split}.npz with the batch contract of
          `data/batch.py` + mean.npy/std.npy over the 75-dim
          [global_orient(3) | body_pose(69) | transl(3)] feature vector
          (the `our_process_smpl_split_NEW/{mean,std}.npy` contract,
          normalization slices exactly as `dataset.py:1501-1627`).

Sequences are cut into non-overlapping windows of `--motion-length` frames,
shorter tails zero-padded with the true length recorded (`dataset.py:1504-1519`).
Image crops (`--images-root`) read the frames with PIL and crop with cv2,
or with PIL when cv2 is not installed; a missing PIL raises an ImportError
that names it.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
from glob import glob

import numpy as np


def windows(n_frames: int, motion_length: int):
    for start in range(0, n_frames, motion_length):
        yield start, min(motion_length, n_frames - start)


def load_recording(path: str):
    return np.load(path, allow_pickle=True).item()


def aa_to_rot6d(aa: np.ndarray) -> np.ndarray:
    """axis-angle (..., J, 3) -> diffusion-layout rot6d (..., J, 6): the
    (3, 2) column block of R flattened row-major (`compute_mean_std.py:50-56`)."""
    from scipy.spatial.transform import Rotation

    shape = aa.shape[:-1]
    R = Rotation.from_rotvec(aa.reshape(-1, 3)).as_matrix()
    return R[..., :, :2].reshape(*shape, 6).astype(np.float32)


def rotmat_to_aa(R: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(R.reshape(-1, 3, 3)).as_rotvec().astype(np.float32)


def _apply_interactee_pred(interactee: dict, imgnames, pred_dict: dict) -> dict:
    """Replace interactee global_orient/body_pose/betas with per-frame EgoHMR
    predictions keyed by image name — transl stays ground truth
    (`dataset.py:1300-1323`, note the '!!! NOT FROM EgoHMR !!!' comment)."""
    go, bp, bt = [], [], []
    for img in imgnames:
        p = pred_dict[img]["smpl_parameters"]
        go.append(np.asarray(p["global_orient"], np.float32).reshape(-1))
        bp.append(np.asarray(p["body_pose"], np.float32).reshape(-1))
        bt.append(np.asarray(p["betas"], np.float32).reshape(-1))
    return {
        "global_orient": np.stack(go),
        "body_pose": np.stack(bp),
        "betas": np.stack(bt),
        "transl": np.asarray(interactee["transl"], np.float32),
    }


def _egoego_per_frame(imgnames, pred_dict: dict):
    """EgoEgo-predicted wearer transl + global orient (rotmat -> axis-angle),
    carry-forward on missing frames (`dataset.py:1343-1367`)."""
    transl, orient = [], []
    for img in imgnames:
        entry = pred_dict.get(img)
        if entry is None:
            transl.append(transl[-1] if transl else np.zeros(3, np.float32))
            orient.append(orient[-1] if orient else np.eye(3, dtype=np.float32))
        else:
            transl.append(np.asarray(entry["transl"], np.float32).reshape(3))
            orient.append(np.asarray(entry["global_orient"], np.float32).reshape(3, 3))
    return (np.stack(transl),
            rotmat_to_aa(np.stack(orient)).reshape(-1, 3))


def _pil_image():
    """PIL's Image module, or an ImportError naming Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"image crops need Pillow (PIL), which is not installed ({e})") from e
    return Image


def _crop_resize(img: np.ndarray, cx: float, cy: float, size: float,
                 out_size: int = 224) -> np.ndarray:
    """Square crop centered at (cx, cy) with side `size`, resized to
    out_size — the `generate_image_patch` role (`EgoHMR/utils/other_utils.py`)
    without rotation/flip (the ego loader passes rot=0, flip=False,
    `dataset.py:1674-1684`). cv2 warpAffine when available, PIL otherwise."""
    try:
        import cv2

        t = np.array([[1, 0, out_size / 2 - cx * out_size / size],
                      [0, 1, out_size / 2 - cy * out_size / size]], np.float32)
        scaled = cv2.resize(
            img, None, fx=out_size / size, fy=out_size / size,
            interpolation=cv2.INTER_LINEAR)
        return cv2.warpAffine(scaled, t, (out_size, out_size))
    except ImportError:
        Image = _pil_image()
        x0, y0 = int(round(cx - size / 2)), int(round(cy - size / 2))
        x1, y1 = int(round(cx + size / 2)), int(round(cy + size / 2))
        h, w = img.shape[:2]
        pad = np.zeros((y1 - y0, x1 - x0, img.shape[2]), img.dtype)
        sx0, sy0 = max(x0, 0), max(y0, 0)
        sx1, sy1 = min(x1, w), min(y1, h)
        if sx1 > sx0 and sy1 > sy0:
            pad[sy0 - y0: sy1 - y0, sx0 - x0: sx1 - x0] = img[sy0:sy1, sx0:sx1]
        return np.asarray(
            Image.fromarray(pad).resize((out_size, out_size), Image.BILINEAR))


def _window_crops(rec: dict, images_root: str, start: int, length: int,
                  k: int, seed: int) -> np.ndarray:
    """k per-window image crops (uint8 RGB) sampled from the window's frames
    (`dataset.py:1657-1706`: bbox from recording_utils center/scale with the
    reference's `center + bbox_size` offset quirk preserved)."""
    utils = rec["recording_utils"]
    names = list(utils["original_imgname"])[start: start + length]
    centers = np.asarray(utils["center"], np.float32).reshape(-1, 2)[start: start + length]
    scales = np.asarray(utils["scale"], np.float32).reshape(-1)[start: start + length]
    rng = np.random.RandomState(seed)
    idxs = rng.randint(0, len(names), size=k)
    crops = []
    Image = _pil_image()
    for i in idxs:
        path = os.path.join(images_root, names[i])
        img = np.asarray(Image.open(path).convert("RGB"))
        bbox = scales[i] * 200.0
        cx, cy = centers[i, 0] + bbox, centers[i, 1] + bbox
        crops.append(_crop_resize(img, cx, cy, bbox).astype(np.uint8))
    return np.stack(crops)


def extract_sequences(rec: dict, motion_length: int, pose_dims: int = 69,
                      data_type: str = "angle",
                      interactee_pred: dict | None = None,
                      egoego_pred: dict | None = None,
                      images_root: str | None = None,
                      crops_per_window: int = 4):
    """One recording dict -> list of fixed-shape examples (unnormalized)."""
    out = []
    wearer, interactee = rec["wearer"], rec["interactee"]
    utils = rec.get("recording_utils", {})
    n = np.asarray(wearer["body_pose"]).shape[0]
    imgnames = list(utils.get("original_imgname", []))
    if interactee_pred is not None:
        interactee = _apply_interactee_pred(interactee, imgnames[:n], interactee_pred)
    egoego = _egoego_per_frame(imgnames[:n], egoego_pred) if egoego_pred else None

    def actor_feats(actor, s, length):
        go = np.asarray(actor["global_orient"], np.float32).reshape(n, -1)[s : s + length]
        bp = np.asarray(actor["body_pose"], np.float32).reshape(n, -1)[s : s + length, :pose_dims]
        tr = np.asarray(actor["transl"], np.float32).reshape(n, -1)[s : s + length]
        bt = np.asarray(actor["betas"], np.float32).reshape(n, -1)[s : s + length]
        return go, bp, tr, bt

    # rot6d: (root + body joints) x diffusion-layout 6d, 144 dims for the
    # 24-joint egobody layout (`mld.py:100`, `compute_mean_std.py:50-56`)
    n_feat = (1 + pose_dims // 3) * 6 if data_type == "rot6d" else 3 + pose_dims
    for start, length in windows(n, motion_length):
        ex = {"length": np.int32(length)}
        feats = np.zeros((motion_length, 2, n_feat), np.float32)
        transl = np.zeros((2, motion_length, 3), np.float32)
        betas = np.zeros((2, motion_length, 10), np.float32)
        for a, actor in enumerate((wearer, interactee)):  # 0=wearer, 1=interactee
            go, bp, tr, bt = actor_feats(actor, start, length)
            if data_type == "rot6d":
                aa = np.concatenate([go, bp], axis=-1).reshape(length, -1, 3)
                feats[:length, a] = aa_to_rot6d(aa).reshape(length, -1)
            else:
                feats[:length, a, :3] = go
                feats[:length, a, 3:] = bp
            transl[a, :length] = tr
            betas[a, :length] = bt[:, :10]
        cam = np.zeros((motion_length, 6), np.float32)
        for i, key in enumerate(("fx", "cx", "cy")):
            if key in utils:
                v = np.asarray(utils[key], np.float32).reshape(-1)
                cam[:length, i] = v[start : start + length] if v.size >= n else v[0]
        ex.update(feats=feats, transl=transl, betas=betas, cam=cam)
        if egoego is not None:
            eg_t = np.zeros((motion_length, 3), np.float32)
            eg_o = np.zeros((motion_length, 3), np.float32)
            eg_t[:length] = egoego[0][start : start + length]
            eg_o[:length] = egoego[1][start : start + length]
            ex.update(egoego_transl=eg_t, egoego_orient=eg_o)
        if images_root is not None:
            ex["image_crops"] = _window_crops(
                rec, images_root, start, length, crops_per_window,
                seed=start + length)
        out.append(ex)
    return out


def compute_mean_std(examples, pose_dims: int = 69):
    """[pose-feats | transl] stats over valid frames of BOTH actors — 75-dim
    for the angle layout, 147-dim for rot6d (the `compute_mean_std.py` /
    `compute_mean_std_gimo.py` contract)."""
    rows = []
    for ex in examples:
        L = int(ex["length"])
        for a in range(2):
            rows.append(
                np.concatenate([ex["feats"][:L, a], ex["transl"][a, :L]], axis=-1)
            )
    flat = np.concatenate(rows)
    mean = flat.mean(0, keepdims=True)
    std = flat.std(0, keepdims=True) + 1e-8
    return mean.astype(np.float32), std.astype(np.float32)


def normalize_examples(examples, mean, std, pose_dims: int = 69):
    P = examples[0]["feats"].shape[-1] if examples else 3 + pose_dims
    m_p, s_p = mean[0, :P], std[0, :P]
    m_t, s_t = mean[0, P : P + 3], std[0, P : P + 3]
    for ex in examples:
        L = int(ex["length"])
        ex["feats"][:L] = (ex["feats"][:L] - m_p) / s_p
        for a in range(2):
            ex["transl"][a, :L] = (ex["transl"][a, :L] - m_t) / s_t
    return examples


def pack(examples):
    keys = ["feats", "transl", "betas", "cam", "length"]
    # optional condition-variant keys (present on all examples or none)
    for k in ("egoego_transl", "egoego_orient", "image_crops"):
        if k in examples[0]:
            keys.append(k)
    return {k: np.stack([ex[k] for ex in examples]) for k in keys}


def attach_scene(packed, scene_dir: str, n_points: int):
    """Optional scene point clouds: one pkl per recording with (N, 3) verts
    (`pcd_verts_dict` contract, `dataset.py:1195-1213`), subsampled/tiled to
    a fixed count."""
    pkls = sorted(glob(os.path.join(scene_dir, "*.pkl")))
    if not pkls:
        return packed
    clouds = []
    for p in pkls:
        with open(p, "rb") as f:
            verts = np.asarray(pickle.load(f), np.float32).reshape(-1, 3)
        idx = np.resize(np.arange(len(verts)), n_points)
        clouds.append(verts[idx])
    n = packed["feats"].shape[0]
    packed["scene"] = np.stack([clouds[i % len(clouds)] for i in range(n)])
    return packed


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.tools.preprocess_egobody")
    ap.add_argument("--root", required=True, help="dataset root (raw/ inside)")
    ap.add_argument("--motion-length", type=int, default=60)
    ap.add_argument("--pose-dims", type=int, default=69, help="69 egobody / 63 gimo")
    ap.add_argument("--scene-points", type=int, default=20000)
    ap.add_argument("--data-type", choices=("angle", "rot6d"), default="angle",
                    help="feature representation (rot6d = 144-d, `mld.py:100`)")
    ap.add_argument("--interactee-pred", default=None,
                    help="EgoHMR predicted-interactee pkl "
                         "(results_interactee_*.pkl, `dataset.py:1215-1223`): "
                         "substitutes interactee pose/betas, keeps GT transl")
    ap.add_argument("--egoego-pred", default=None,
                    help="EgoEgo wearer transl/orient pkl (trans_and_rot_pred/"
                         "data.pkl, `dataset.py:1225-1228`): adds "
                         "egoego_transl/egoego_orient npz keys")
    ap.add_argument("--images-root", default=None,
                    help="EgoBody image root: adds per-window 224x224 uint8 "
                         "crops (image_crops key) for the image condition "
                         "(`dataset.py:1657-1745`)")
    ap.add_argument("--crops-per-window", type=int, default=4)
    args = ap.parse_args(argv)

    interactee_pred = egoego_pred = None
    if args.interactee_pred:
        with open(args.interactee_pred, "rb") as f:
            interactee_pred = pickle.load(f)
    if args.egoego_pred:
        with open(args.egoego_pred, "rb") as f:
            egoego_pred = pickle.load(f)

    proc = os.path.join(args.root, "processed")
    os.makedirs(proc, exist_ok=True)

    all_train = []
    split_examples = {}
    for split in ("train", "val", "test"):
        raw_dir = os.path.join(args.root, "raw", split)
        recs = sorted(glob(os.path.join(raw_dir, "*.npy")))
        examples = []
        for rec_path in recs:
            examples.extend(
                extract_sequences(load_recording(rec_path), args.motion_length,
                                  args.pose_dims, args.data_type,
                                  interactee_pred=interactee_pred,
                                  egoego_pred=egoego_pred,
                                  images_root=args.images_root,
                                  crops_per_window=args.crops_per_window)
            )
        split_examples[split] = examples
        if split == "train":
            all_train = examples
        print(f"{split}: {len(recs)} recordings -> {len(examples)} sequences")

    if not all_train:
        raise SystemExit(f"no training recordings under {args.root}/raw/train")
    mean, std = compute_mean_std(all_train, args.pose_dims)
    np.save(os.path.join(proc, "mean.npy"), mean)
    np.save(os.path.join(proc, "std.npy"), std)

    for split, examples in split_examples.items():
        if not examples:
            continue
        normalize_examples(examples, mean, std, args.pose_dims)
        packed = pack(examples)
        scene_dir = os.path.join(args.root, "raw", "scenes")
        if os.path.isdir(scene_dir):
            packed = attach_scene(packed, scene_dir, args.scene_points)
        np.savez(os.path.join(proc, f"{split}.npz"), **packed)
        print(f"wrote {proc}/{split}.npz:", {k: v.shape for k, v in packed.items()})
    return proc


if __name__ == "__main__":
    main(sys.argv[1:])
