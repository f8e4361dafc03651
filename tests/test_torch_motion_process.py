"""The HumanML3D / KIT feature pipeline of the port against the JAX
package's numpy one on the CPU: `process_file` for both skeletons with and
without retargeting (1e-10 of max |features|, both in float64), its
skeleton pieces (offsets, inverse and forward kinematics, `qfix`,
`qbetween`, the 6-D rotations), the facing-direction smoothing against
scipy, the recovery of the canonical joints from the features (5e-3, the
JAX test's bound: the recovery integrates velocities in float32), the
`preprocess_humanml` CLI against the root tool on one folder (the float32
feature files 1e-6 of max, recovered joints 1e-5 of max, statistics 1e-6
relative), and
the last two rotation helpers, `quat_to_aa` / `rotmat_to_aa` (1e-5).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter1d

from seeme_tpu.core import motion_process as jmp
from seeme_tpu.core import rotations as jrot
from seeme_tpu_torch.core import motion_process as pmp
from seeme_tpu_torch.core import rotations as prot
from seeme_tpu_torch.core.ric import recover_from_ric
from seeme_tpu_torch.tools import preprocess_humanml
from test_motion_process import _synthetic_motion
from tools import preprocess_humanml as j_preprocess

FEAT_RTOL = 1e-10
SPECS = [("humanml3d", 263), ("kit", 251)]


def close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(float(np.abs(want).max()), 1e-30))


def t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


@pytest.mark.parametrize("name,nfeats", SPECS)
@pytest.mark.parametrize("retarget", [False, True])
def test_process_file_matches_numpy(name, nfeats, retarget):
    jspec, pspec = jmp.SPECS[name], pmp.SPECS[name]
    joints = _synthetic_motion(jspec, T=30, seed=1, scale=1.3)
    example = _synthetic_motion(jspec, T=4, seed=9)
    jt = jmp.get_offsets_joints(example[0], jspec) if retarget else None
    pt = pmp.get_offsets_joints(t(example[0]), pspec) if retarget else None
    if retarget:
        close(pt, jt, FEAT_RTOL)
    want = jmp.process_file(joints, jspec, tgt_offsets=jt)
    got = pmp.process_file(t(joints), pspec, tgt_offsets=pt)
    assert got[0].shape == (29, nfeats) and got[0].dtype == torch.float64
    for g, w in zip(got, want):
        close(g, w, FEAT_RTOL)
    # the foot contacts are exact
    np.testing.assert_array_equal(got[0][:, -4:].numpy(), want[0][:, -4:])


def test_skeleton_pieces_match_numpy():
    spec, pspec = jmp.HUMANML3D, pmp.HUMANML3D
    joints = _synthetic_motion(spec, T=12, seed=3)
    for smooth in (False, True):
        close(pmp.inverse_kinematics(t(joints), pspec, smooth_forward=smooth),
              jmp.inverse_kinematics(joints, spec, smooth_forward=smooth), FEAT_RTOL)
    quat = jmp.inverse_kinematics(joints, spec)
    offsets = jmp.get_offsets_joints(joints[0], spec)
    for root_r in (True, False):
        close(pmp.forward_kinematics(t(quat), t(joints[:, 0]), t(offsets), pspec, do_root_R=root_r),
              jmp.forward_kinematics(quat, joints[:, 0], offsets, spec, do_root_R=root_r),
              FEAT_RTOL)
    close(pmp.uniform_skeleton(t(joints), t(offsets * 1.2), pspec),
          jmp.uniform_skeleton(joints, offsets * 1.2, spec), FEAT_RTOL)
    q = np.random.RandomState(4).randn(9, 5, 4)
    np.testing.assert_array_equal(pmp.qfix(t(q)).numpy(), jmp.qfix(q))
    v0, v1 = np.random.RandomState(5).randn(2, 7, 3)
    close(pmp.qbetween(t(v0), t(v1)), jmp.qbetween(v0, v1), FEAT_RTOL)
    close(pmp.quat_to_cont6d(t(q)), jmp.quat_to_cont6d(q), FEAT_RTOL)
    x = np.random.RandomState(6).randn(50, 3)  # shorter than the 81-tap kernel's reach
    close(pmp.gaussian_smooth(t(x)), gaussian_filter1d(x, 20, axis=0, mode="nearest"), 1e-12)
    with pytest.raises(ValueError, match="T, J, 4"):
        pmp.qfix(t(q[0]))


def test_recovery_gives_back_the_canonical_joints():
    spec = pmp.HUMANML3D
    joints = _synthetic_motion(jmp.HUMANML3D, T=30, seed=2)
    data, glob, _, _ = pmp.process_file(t(joints), spec)
    rec = recover_from_ric(data.to(torch.float32), spec.joints_num)
    np.testing.assert_allclose(rec.numpy(), glob[:-1].numpy(), atol=5e-3)


def test_preprocess_cli_matches_the_root_tool(tmp_path, monkeypatch):
    src = tmp_path / "joints"
    src.mkdir()
    for i in range(3):
        np.save(src / f"{i:06d}.npy", _synthetic_motion(jmp.HUMANML3D, T=20 + 5 * i, seed=10 + i))
    np.save(src / "short.npy", np.zeros((2, 22, 3)))
    outs = {}
    for who in ("ours", "ref"):
        d = tmp_path / who
        d.mkdir()
        argv = ["--joints_dir", str(src), "--example", "000000.npy",
                "--out_vecs", str(d / "vecs"), "--out_joints", str(d / "joints"),
                "--stats", str(d)]
        if who == "ours":
            result = preprocess_humanml.main(argv + ["--cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["preprocess_humanml.py"] + argv)
            j_preprocess.main()
        outs[who] = d
    assert result["processed"] == ["000000.npy", "000001.npy", "000002.npy"]
    assert result["skipped"] == ["short.npy"]
    assert sorted(os.listdir(outs["ours"] / "vecs")) == sorted(os.listdir(outs["ref"] / "vecs"))
    for f in os.listdir(outs["ref"] / "vecs"):
        close(np.load(outs["ours"] / "vecs" / f), np.load(outs["ref"] / "vecs" / f), 1e-6)
        close(np.load(outs["ours"] / "joints" / f), np.load(outs["ref"] / "joints" / f), 1e-5)
    for stat in ("Mean.npy", "Std.npy"):
        np.testing.assert_allclose(np.load(outs["ours"] / stat), np.load(outs["ref"] / stat),
                                   rtol=1e-6, atol=1e-7)


def test_quat_and_rotmat_to_axis_angle():
    rng = np.random.RandomState(8)
    q = rng.randn(6, 4).astype(np.float32)
    q[0] = [1.0, 0.0, 0.0, 0.0]          # identity: the limit branch
    q[1] = [-0.5, 0.5, 0.5, 0.5]         # negative w
    aa = rng.randn(5, 3).astype(np.float32)
    R = np.array(jrot.aa_to_rotmat(jnp.asarray(aa)))
    close(prot.quat_to_aa(torch.as_tensor(q)), jrot.quat_to_aa(jnp.asarray(q)), 1e-5)
    close(prot.rotmat_to_aa(torch.as_tensor(R)), jrot.rotmat_to_aa(jnp.asarray(R)), 1e-5)
    close(prot.rotmat_to_aa(torch.as_tensor(R)), aa, 1e-4)
