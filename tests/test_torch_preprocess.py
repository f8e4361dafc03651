"""The EgoHMR scene preprocessing of the port against the root tool on the
CPU: the geometric cores (OBJ vertices, homogeneous transforms, the front
crop, the uniform downsample with its tiling and empty cases, the
body-cube crop with and without its random yaw and shift, on one
`RandomState`) bitwise, then `run_s1` / `run_s2` on a small fabricated EgoBody
release: s1's pickles bitwise and s2's cropped scenes, whose ground-truth
body is `smpl_forward` of an SMPL file the test writes (float32 bodies of
the two packages: crops equal to 1e-6 of max |.|).
"""

import csv
import json
import pickle

import numpy as np
import pytest
import torch

from seeme_tpu_torch.core.smpl import save_smpl, synthetic_smpl
from seeme_tpu_torch.tools import preprocess_scene_egohmr as ours
from tools import preprocess_scene_egohmr as ref


def test_obj_and_transforms_match(tmp_path):
    rng = np.random.RandomState(0)
    verts = rng.randn(40, 3)
    path = tmp_path / "m.obj"
    path.write_text("# mesh\n" + "".join(f"v {x:.17g} {y:.17g} {z:.17g}\n" for x, y, z in verts)
                    + "vn 0 0 1\nf 1 2 3\n")
    np.testing.assert_array_equal(ours.load_obj_vertices(str(path)),
                                  ref.load_obj_vertices(str(path)))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = np.linalg.qr(rng.randn(3, 3))[0], rng.randn(3)
    np.testing.assert_array_equal(ours.apply_transform(verts, T), ref.apply_transform(verts, T))
    np.testing.assert_array_equal(ours.front_crop(verts), ref.front_crop(verts))
    for target in (7, 40, 100):
        np.testing.assert_array_equal(ours.uniform_downsample(verts, target),
                                      ref.uniform_downsample(verts, target))
    np.testing.assert_array_equal(ours.uniform_downsample(verts[:0], 5),
                                  ref.uniform_downsample(verts[:0], 5))
    np.testing.assert_array_equal(ours.ADD_TRANS, ref.ADD_TRANS)


@pytest.mark.parametrize("augment", [True, False])
def test_body_cube_crop_matches(augment):
    rng = np.random.RandomState(1)
    scene = rng.rand(3000, 3) * np.array([6.0, 3.0, 6.0]) - np.array([3.0, 0.0, 3.0])
    body = rng.randn(200, 3) * 0.2 + np.array([0.3, 0.9, -0.2])
    got = ours.crop_scene_cube_around_body(scene, body, 2.0, 500, np.random.RandomState(5),
                                           augment)
    want = ref.crop_scene_cube_around_body(scene, body, 2.0, 500, np.random.RandomState(5),
                                           augment)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (500, 3)


def fake_release(root, body_path, n_frames=4):
    """The files `run_s1` / `run_s2` read, for one recording in one scene."""
    rng = np.random.RandomState(2)
    rec, seq, scene = "recording_20210907_S02_S01_01", "2021-09-07-164904", "seminar_g110"
    with open(root / "data_info_release.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["recording_name", "scene_name"])
        w.writerow([rec, scene])
    frames = [f"frame_{i:05d}" for i in range(n_frames)]
    names = [f"egocentric_color/{rec}/{seq}/PV/{i:03d}_{fr}.jpg"
             for i, fr in enumerate(frames)]
    (root / "smpl_spin_npz").mkdir()
    np.savez(root / "smpl_spin_npz" / "egocapture_train_smpl.npz", imgname=np.array(names),
             shape=rng.randn(n_frames, 10) * 0.3, pose=rng.randn(n_frames, 72) * 0.2,
             global_orient_pv=rng.randn(n_frames, 3) * 0.2,
             transl_pv=rng.randn(n_frames, 3) * 0.1 + np.array([0.0, 0.0, 2.0]))

    def rigid():
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = np.linalg.qr(rng.randn(3, 3))[0], rng.randn(3) * 0.2
        return T

    with open(root / "transf_matrices_all_seqs.pkl", "wb") as f:
        pickle.dump({seq: {"trans_kinect2holo": rigid(),
                           "trans_world2pv": {n.split("/")[-1][-15:-4]: rigid()
                                              for n in names}}}, f)
    (root / "scene_mesh" / scene).mkdir(parents=True)
    verts = rng.rand(4000, 3) * 6.0 - 3.0
    (root / "scene_mesh" / scene / f"{scene}.obj").write_text(
        "".join(f"v {x:.17g} {y:.17g} {z:.17g}\n" for x, y, z in verts))
    cal = root / "calibrations" / rec / "cal_trans" / "kinect12_to_world"
    cal.mkdir(parents=True)
    (cal / f"{scene}.json").write_text(json.dumps({"trans": rigid().tolist()}))
    save_smpl(synthetic_smpl(n_verts=256, seed=3), str(body_path))


def test_stages_match_the_root_tool(tmp_path):
    data = tmp_path / "release"
    data.mkdir()
    body = tmp_path / "SMPL_NEUTRAL.pkl"
    fake_release(data, body)
    for who, mod in (("ours", ours), ("ref", ref)):
        mod.run_s1(str(data), str(tmp_path / who / "s1"), "train", target=300, cache_every=3)
        kwargs = {"device": "cpu"} if who == "ours" else {}
        mod.run_s2(str(data), str(tmp_path / who / "s2"), "train", target=300, cube_size=2.0,
                   smpl_path=str(body), seed=4, **kwargs)
    for name in ("map_dict_train.pkl", "pcd_verts_dict_train.pkl"):
        got = pickle.load(open(tmp_path / "ours" / "s1" / name, "rb"))
        want = pickle.load(open(tmp_path / "ref" / "s1" / name, "rb"))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    files = sorted(str(p.relative_to(tmp_path / "ref" / "s2"))
                   for p in (tmp_path / "ref" / "s2").rglob("*.npy"))
    assert len(files) == 4 and files == sorted(
        str(p.relative_to(tmp_path / "ours" / "s2")) for p in (tmp_path / "ours" / "s2").rglob("*.npy"))
    for f in files:
        got, want = np.load(tmp_path / "ours" / "s2" / f), np.load(tmp_path / "ref" / "s2" / f)
        assert got.shape == (300, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(np.abs(want).max()))


def test_s2_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ours.main(["--stage", "s2", "--data_root", str(tmp_path), "--save_root", str(tmp_path)])
