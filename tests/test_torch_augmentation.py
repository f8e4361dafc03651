"""The port's copy of the EgoHMR training augmentation
(`seeme_tpu_torch/data/augmentation.py`), its `MoCapDataset`, and the image
data module's augmented batches and real-release loader, against the JAX
package on the same `np.random.RandomState` draws: the same arrays, within
1e-6 (float32 host arithmetic in the same order), on the cv2 and the scipy
route of the patch warp. The release's npz files are written by the test.
"""

import sys

import numpy as np
import pytest

from seeme_tpu.data import augmentation as jaug
from seeme_tpu.data import egohmr_images as j_images
from seeme_tpu_torch.data import augmentation as aug
from seeme_tpu_torch.data import egohmr_images as images

IMG, POINTS = 48, 64


def example(seed):
    return images.synthetic_image_example(np.random.RandomState(seed), POINTS, IMG)


def assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-6, atol=1e-6)


CASES = {
    "sample_augmentation": lambda m, rs: [m.sample_augmentation(rs, m.AugmentConfig())
                                         for _ in range(50)],
    "gen_trans_from_patch": lambda m, rs: m.gen_trans_from_patch(
        *rs.rand(4) * 100, 64, 64, 0.8 + rs.rand(), rs.randn() * 30),
    "rot_aa": lambda m, rs: m.rot_aa(rs.randn(3).astype(np.float32), rs.randn() * 30),
    "fliplr_params": lambda m, rs: m.fliplr_params(
        {"global_orient": rs.randn(3), "body_pose": rs.randn(69), "betas": rs.randn(10),
         "transl": rs.randn(3)}),
    "keypoint_3d_processing": lambda m, rs: [m.keypoint_3d_processing(rs.randn(24, 3), r, f)
                                             for r in (0.0, 25.0) for f in (False, True)],
    "scene_verts_3d_processing": lambda m, rs: m.scene_verts_3d_processing(
        rs.randn(100, 3), -40.0, True),
    "augment_example": lambda m, rs: [m.augment_example(example(i), rs) for i in range(6)],
    "augment_batch": lambda m, rs: m.augment_batch(
        {k: np.stack([example(i)[k] for i in range(4)]) for k in example(0)}, rs),
}


@pytest.mark.parametrize("name", list(CASES))
def test_same_draws_give_the_same_arrays(name):
    assert_same(CASES[name](aug, np.random.RandomState(7)),
                CASES[name](jaug, np.random.RandomState(7)))


@pytest.mark.parametrize("route", ["cv2", "scipy"])
def test_patch_warp_matches_jax(route, monkeypatch):
    """`generate_image_patch` flipped, scaled and rotated; `scipy` hides cv2
    from both packages."""
    if route == "cv2":
        pytest.importorskip("cv2")
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.random.RandomState(1).rand(IMG, IMG, 3).astype(np.float32)
    args = (img, 20.0, 26.0, 40, 36, IMG, IMG, True, 1.2, 17.0)
    got, trans = aug.generate_image_patch(*args)
    want, jtrans = jaug.generate_image_patch(*args)
    assert_same((got, trans), (want, jtrans))
    assert np.abs(got).max() > 0.1


def test_mocap_dataset_matches_jax(tmp_path):
    """The synthetic fallback and an npz the test writes (body_pose's first
    three values, the global orient, dropped): the same endless batches."""
    rs = np.random.RandomState(0)
    path = tmp_path / "cmu_mocap.npz"
    np.savez(path, body_pose=rs.randn(40, 72).astype(np.float32),
             betas=rs.randn(40, 10).astype(np.float32))
    for src in (None, str(path)):
        ours, theirs = aug.MoCapDataset(src), jaug.MoCapDataset(src)
        assert ours.is_synthetic == theirs.is_synthetic == (src is None)
        a = ours.batches(16, np.random.RandomState(3))
        b = theirs.batches(16, np.random.RandomState(3))
        for _ in range(5):  # past the end of the 40-pose file: a new permutation
            assert_same(next(a), next(b))
    assert ours.pose.shape == (40, 69)


def write_release(root, n=6):
    """processed_images/{train,test}.npz in the flat example schema; no val."""
    proc = root / "processed_images"
    proc.mkdir()
    for i, name in enumerate(("train", "test")):
        rs = np.random.RandomState(10 + i)
        exs = [images.synthetic_image_example(rs, POINTS, IMG) for _ in range(n)]
        np.savez(proc / f"{name}.npz", **{k: np.stack([e[k] for e in exs]) for k in exs[0]})


@pytest.mark.parametrize("augment", [False, True])
def test_release_loader_matches_jax(tmp_path, augment):
    write_release(tmp_path)
    ours = images.EgoHmrImageDataModule(root=str(tmp_path), n_pts=POINTS, img_size=IMG)
    theirs = j_images.EgoHmrImageDataModule(root=str(tmp_path), n_pts=POINTS, img_size=IMG)
    assert not ours.is_synthetic and not theirs.is_synthetic
    for split in ("train", "test"):
        a = list(ours.batches(split, 4, seed=2, augment=augment, drop_last=False))
        b = list(theirs.batches(split, 4, seed=2, augment=augment, drop_last=False))
        assert len(a) == len(b) == 2
        assert_same(a, b)
    with pytest.raises(KeyError):
        ours.split("val")


def test_synthetic_augmented_batches_match_jax():
    """The synthetic train split's augmented batches, as the training CLIs
    draw them (`seed=epoch`)."""
    ours = images.EgoHmrImageDataModule(n_pts=POINTS, img_size=IMG)
    theirs = j_images.EgoHmrImageDataModule(n_pts=POINTS, img_size=IMG)
    assert ours.is_synthetic and theirs.is_synthetic
    for seed in (0, 1):
        assert_same(list(ours.batches("train", 16, seed=seed, augment=True)),
                    list(theirs.batches("train", 16, seed=seed, augment=True)))
