"""Port parity, small pieces: masks, rotations, SMPL, embeddings, schedule,
metrics and synthetic data of `seeme_tpu_torch` against `seeme_tpu` on the
CPU, f32 against f32 (`jax_default_matmul_precision="highest"`, set by
tests/conftest.py). Inputs come from numpy with a seed and go to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.core import masks as j_masks
from seeme_tpu.core import rotations as j_rot
from seeme_tpu.core import smpl as j_smpl
from seeme_tpu.data.synthetic import SyntheticEgoDataset as JData
from seeme_tpu.diffusion.schedulers import DiffusionSchedule as JSchedule
from seeme_tpu.eval import metrics as j_metrics
from seeme_tpu.nn import embeddings as j_emb
from seeme_tpu.ops import denoiser_fused as j_df
from seeme_tpu_torch.core import masks, rotations, smpl
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset
from seeme_tpu_torch.diffusion.schedulers import DiffusionSchedule
from seeme_tpu_torch.eval import metrics
from seeme_tpu_torch.nn import embeddings
from seeme_tpu_torch.ops.denoiser_fused import ddim_schedule_arrays

T = torch.as_tensor


def close(ours, ref, atol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=0, atol=atol)


def test_lengths_to_mask():
    lengths = np.array([0, 3, 7, 5])
    assert np.array_equal(masks.lengths_to_mask(T(lengths), 7).numpy(),
                          np.asarray(j_masks.lengths_to_mask(jnp.asarray(lengths), 7)))


@pytest.mark.parametrize("fn", ["aa_to_quat", "aa_to_rotmat"])
def test_rotations(fn):
    aa = np.random.RandomState(0).randn(5, 7, 3).astype(np.float32)
    aa[0, 0] = 0.0  # the identity, where the epsilon inside the norm matters
    close(getattr(rotations, fn)(T(aa)), getattr(j_rot, fn)(jnp.asarray(aa)), 1e-6)


def test_quat_to_rotmat_normalizes():
    q = np.random.RandomState(1).randn(11, 4).astype(np.float32) * 3.0
    close(rotations.quat_to_rotmat(T(q)), j_rot.quat_to_rotmat(jnp.asarray(q)), 1e-6)


def test_synthetic_smpl_is_the_same_body():
    ours, ref = smpl.synthetic_smpl(300, seed=4), j_smpl.synthetic_smpl(300, seed=4)
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
                 "parents", "extra_joint_ids"):
        assert np.array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name))), name
    assert np.array_equal(ours.faces, ref.faces)


def _pose(rng, n):
    return (rng.randn(n, 10).astype(np.float32) * 0.5, rng.randn(n, 69).astype(np.float32) * 0.3,
            rng.randn(n, 3).astype(np.float32) * 0.5, rng.randn(n, 3).astype(np.float32))


def test_smpl_joints24():
    rng = np.random.RandomState(2)
    betas, pose, glob, transl = _pose(rng, 6)
    ours = smpl.smpl_joints24(smpl.synthetic_smpl(256), T(betas), T(pose), T(glob), T(transl))
    ref = j_smpl.smpl_joints24(j_smpl.synthetic_smpl(256), *map(jnp.asarray, (betas, pose, glob, transl)))
    assert ours.shape == (6, 24, 3)
    close(ours, ref, 1e-5)


def test_rigid_transforms():
    rng = np.random.RandomState(3)
    rot = np.asarray(j_rot.aa_to_rotmat(jnp.asarray(rng.randn(4, 24, 3).astype(np.float32))))
    joints = rng.randn(4, 24, 3).astype(np.float32)
    pj, rel = smpl._rigid_transforms(T(rot.copy()), T(joints), T(smpl.PARENTS))
    pj_ref, rel_ref = j_smpl._rigid_transforms(jnp.asarray(rot), jnp.asarray(joints),
                                              jnp.asarray(j_smpl.PARENTS))
    close(pj, pj_ref, 1e-5)
    close(rel, rel_ref, 1e-5)
    with pytest.raises(ValueError, match="canonical"):
        smpl._rigid_transforms(T(rot.copy()), T(joints), T(np.roll(smpl.PARENTS, 1)))


def test_sinusoidal_timestep_embedding():
    t = np.array([1, 21, 500, 981])
    for dim in (32, 33):
        close(embeddings.sinusoidal_timestep_embedding(T(t), dim),
              j_emb.sinusoidal_timestep_embedding(jnp.asarray(t), dim), 1e-5)


def test_timestep_embedding_mlp_and_learned_pe():
    rng = np.random.RandomState(5)
    mlp = embeddings.TimestepEmbedding(16, 24).requires_grad_(False)
    pe = embeddings.LearnedPositionalEncoding(24, max_len=10).requires_grad_(False)
    with torch.no_grad():
        for p in [*mlp.parameters(), *pe.parameters()]:
            p.copy_(T(rng.randn(*p.shape).astype(np.float32) * 0.3))
    x = rng.randn(3, 16).astype(np.float32)
    params = {"params": {n: {"kernel": jnp.asarray(getattr(mlp, n).weight.numpy().T),
                             "bias": jnp.asarray(getattr(mlp, n).bias.numpy())}
                         for n in ("linear_1", "linear_2")}}
    close(mlp(T(x)).detach(), j_emb.TimestepEmbedding(24).apply(params, jnp.asarray(x)), 1e-5)
    seq = rng.randn(2, 7, 24).astype(np.float32)
    ref = j_emb.LearnedPositionalEncoding(24, max_len=10).apply(
        {"params": {"pe": jnp.asarray(pe.pe.detach().numpy()[:, 0])}}, jnp.asarray(seq))
    close(pe(T(seq)).detach(), ref, 1e-6)
    with pytest.raises(ValueError):
        embeddings.build_position_encoding(8, "sine")


def test_schedule_and_ddim_step():
    ours, ref = DiffusionSchedule(), JSchedule()
    np.testing.assert_array_equal(ours.alphas_cumprod, ref.alphas_cumprod_np)
    np.testing.assert_array_equal(ours.ddim_timesteps(50), ref.ddim_timesteps(50))
    rng = np.random.RandomState(6)
    eps, x = rng.randn(2, 3, 4, 8).astype(np.float32)
    for t in (981, 501, 1):
        close(ours.ddim_step(T(eps), t, T(x), 50),
              ref.ddim_step(jnp.asarray(eps), jnp.asarray(t), jnp.asarray(x), 50), 1e-5)


def test_ddim_schedule_arrays():
    for got, want in zip(ddim_schedule_arrays(DiffusionSchedule(), 50),
                         j_df.ddim_schedule_arrays(JSchedule(), 50)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_synthetic_dataset_same_arrays():
    ours = SyntheticEgoDataset(5, 20, scene_points=64, seed=7)
    ref = JData(5, 20, scene_points=64, seed=7)
    for name in ("feats", "transl", "betas", "cam", "scene", "length", "mean", "std"):
        assert np.array_equal(getattr(ours, name), getattr(ref, name)), name
    b = ours.batch(1, 3)
    assert b["feats"].shape == (3, 20, 2, 72) and b["scene"].shape == (3, 64, 3)
    np.testing.assert_array_equal(b["transl"], ref.transl[1:4])


def _metric_inputs(seed=8, B=5, Tn=12):
    rng = np.random.RandomState(seed)
    jp = rng.randn(B, Tn, 24, 3).astype(np.float32) * 0.1
    jg = jp + rng.randn(B, Tn, 24, 3).astype(np.float32) * 0.05
    qp = rng.randn(B, Tn, 4).astype(np.float32)
    qg = qp + rng.randn(B, Tn, 4).astype(np.float32) * [[[0.1]], [[0.1]], [[3.0]], [[0.1]], [[0.1]]]
    jg[3] += np.linspace(0, 1, Tn, dtype=np.float32)[:, None, None]  # root error > 300 mm
    mask = np.ones((B, Tn), bool)
    mask[1, 9:] = False
    return jp, jg, qp.astype(np.float32), qg.astype(np.float32), mask


def test_ego_sequence_metrics():
    args = _metric_inputs()
    ours = metrics.ego_sequence_metrics(*map(T, args))
    ref = j_metrics.ego_sequence_metrics(*map(jnp.asarray, args))
    for k in ("mpjpe", "root_err", "head_err", "accl"):
        close(ours[k], ref[k], 1e-3 if k != "head_err" else 1e-5)


def test_filtered_means_match_ego_metric():
    args = _metric_inputs()
    per_seq = metrics.ego_sequence_metrics(*map(T, args))
    ours = metrics.filtered_means(per_seq)
    acc = j_metrics.EgoMetric(split="test")
    acc.update(*map(jnp.asarray, args))
    ref = acc.compute()
    assert 0 < ours["kept"] < 5 and ours["kept"] == acc.counts["MPJPE"]
    for k in ("MPJPE", "ROOT_ERROR", "HEAD_ORIENTATION_ERROR", "ACCL"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5)
