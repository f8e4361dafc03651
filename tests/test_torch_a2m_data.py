"""The port's action-to-motion data against the JAX package's: the synthetic
datamodules (HumanAct12, 12 classes; UESTC, 40) bitwise, and both release
loaders on tiny releases written to `tmp_path` (the fixtures of
`tests/test_a2m.py`), array for array and batch for batch; and the
registry's choice between a release and the synthetic data.
"""

import pickle

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from seeme_tpu.data.a2m import HumanAct12DataModule as JHumanAct12
from seeme_tpu.data.a2m import UestcDataModule as JUestc
from seeme_tpu.data.registry import SyntheticA2MDataModule as JSynthetic
from seeme_tpu_torch.data.a2m import HumanAct12DataModule, UestcDataModule, _y_rotation
from seeme_tpu_torch.data.registry import SyntheticA2MDataModule, get_datamodule


def same_splits(ours, theirs, splits=("train", "val", "test")):
    for split in splits:
        a, b = ours.split_arrays(split), theirs.split_arrays(split)
        assert set(a) == set(b) == {"motion", "action", "length"}, split
        for k in a:
            assert a[k].dtype == b[k].dtype, (split, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{split} {k}")
        for shuffle, seed in ((None, 3), (False, 0)):
            for x, y in zip(ours.batches(split, 7, shuffle=shuffle, seed=seed, drop_last=False),
                            theirs.batches(split, 7, shuffle=shuffle, seed=seed,
                                           drop_last=False)):
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k])
    for attr in ("nfeats", "num_classes", "num_train", "is_synthetic", "name"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    np.testing.assert_array_equal(ours.mean, theirs.mean)
    np.testing.assert_array_equal(ours.std, theirs.std)


@pytest.mark.parametrize("name,classes", [("humanact12", 12), ("uestc", 40)])
def test_synthetic_datamodule_is_bitwise_the_jax_one(name, classes):
    ours = SyntheticA2MDataModule(classes, name=name)
    theirs = JSynthetic({"DATASET_NAME": name}, num_classes=classes)
    same_splits(ours, theirs)
    assert ours.num_train == 240 and ours.split_arrays("test")["motion"].shape == (60, 60, 150)


def write_humanact12(path):
    rng = np.random.RandomState(0)
    clips = {"poses": [], "joints3D": [], "y": []}
    for i, T in enumerate((70, 30, 45, 1)):  # the last, one frame, is skipped
        clips["poses"].append(rng.randn(T, 72).astype(np.float32) * 0.3)
        clips["joints3D"].append(rng.randn(T, 24, 3).astype(np.float32))
        clips["y"].append(i % 12)
    with open(path, "wb") as f:
        pickle.dump(clips, f)
    return path


def write_uestc(root, with_globtrans=False):
    """(action, view, subject, side, frames): train, a rotated side-2 train
    clip, a skipped view 8 of side 2, a test clip, a short train clip
    dropped by the 3/4 filter, and a long test clip strided to 60 frames."""
    rng = np.random.RandomState(0)
    specs = [(0, 1, 1, 1, 120), (5, 2, 1, 2, 80), (7, 8, 1, 2, 80), (3, 1, 3, 1, 50),
             (9, 1, 1, 1, 20), (11, 3, 4, 2, 200)]
    names, poses, joints, cams = [], [], [], []
    for a, v, p, c, T in specs:
        names.append(f"a{a}_d{v}_p{p:03d}_c{c}_color.avi")
        pose = rng.randn(T, 72).astype(np.float32) * 0.2
        if c != 1 and v != 8:
            pose[:, :3] = Rotation.from_matrix(_y_rotation(v).T).as_rotvec().astype(np.float32)
        poses.append(pose)
        joints.append(rng.randn(T, 49, 3).astype(np.float32))
        cam = np.ones((T, 4), np.float32)
        cam[:, 2:] = rng.randn(T, 2).astype(np.float32) * 0.1
        cams.append(cam)
    (root / "info").mkdir(parents=True)
    (root / "info" / "names.txt").write_text("\n".join(names) + "\n")
    (root / "info" / "num_frames_min.txt").write_text("\n".join(str(s[-1] - 3) for s in specs))
    (root / "info" / "action_classes.txt").write_text("\n".join(f"c{i}" for i in range(40)))
    with open(root / "vibe_cache_refined.pkl", "wb") as f:
        pickle.dump({"pose": poses, "joints3d": joints, "orig_cam": cams}, f)
    if with_globtrans:
        with open(root / "globtrans_usez.pkl", "wb") as f:
            pickle.dump([rng.randn(len(p), 3).astype(np.float32) for p in poses], f)
    return root


def test_humanact12_release_matches_jax(tmp_path):
    path = write_humanact12(tmp_path / "humanact12poses.pkl")
    ours, theirs = HumanAct12DataModule(str(path)), JHumanAct12(None, str(path))
    same_splits(ours, theirs)
    assert ours.num_train == 3 and sorted(ours.split_arrays("train")["length"]) == [30, 45, 60]


@pytest.mark.parametrize("with_globtrans", [False, True])
def test_uestc_release_matches_jax(tmp_path, with_globtrans):
    """The VIBE translation recovered (or read from `globtrans_usez.pkl`),
    the side-2 rotation, the view-8 skip, the subject split, the 3/4 filter
    and the strided frames, as the JAX loader gives them."""
    root = write_uestc(tmp_path / "uestc", with_globtrans)
    ours, theirs = UestcDataModule(str(root)), JUestc(None, str(root))
    same_splits(ours, theirs)
    assert ours.num_train == 2 and ours.split_arrays("test")["action"].tolist() == [3, 11]
    side2 = ours.split_arrays("train")["motion"][1]
    np.testing.assert_allclose(side2[0, :6], np.eye(3)[:, :2].reshape(6), atol=1e-5)


def test_registry_takes_a_release_when_there(tmp_path):
    (tmp_path / "HumanAct12Poses").mkdir()
    write_humanact12(tmp_path / "HumanAct12Poses" / "humanact12poses.pkl")
    write_uestc(tmp_path / "uestc")
    h = get_datamodule("humanact12", motion_length=32, root=str(tmp_path))
    u = get_datamodule("uestc", root=str(tmp_path))
    assert not h.is_synthetic and isinstance(h, HumanAct12DataModule)
    assert h.split_arrays("train")["motion"].shape[1] == 32
    assert not u.is_synthetic and u.num_classes == 40
    s = get_datamodule("uestc", motion_length=16, root=str(tmp_path / "absent"))
    assert s.is_synthetic and s.num_classes == 40 and s.name == "uestc"
    assert s.split_arrays("val")["motion"].shape == (60, 16, 150)
