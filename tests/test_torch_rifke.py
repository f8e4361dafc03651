"""Rifke and the APE / AVE metrics of the port against the JAX package on
the CPU: `joints_to_rifke`, `rifke_to_joints` and their round trip (1e-5
of max |.|, float32 both), the floor and facing helpers, and
`ApeAveMetrics` over ragged lengths from tensors and from arrays (1e-6
relative: the sums are host float64 in both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.core import rifke as jrifke
from seeme_tpu.eval.ape_ave import ApeAveMetrics as JApeAve
from seeme_tpu_torch.core import rifke
from seeme_tpu_torch.eval.ape_ave import ApeAveMetrics

RTOL = 1e-5


def walk(seed, B=3, T=24):
    """Joint sequences: a fixed body pose plus a smooth random walk."""
    rng = np.random.RandomState(seed)
    pose = rng.randn(1, 1, 22, 3).astype(np.float32)
    return np.cumsum(rng.randn(B, T, 22, 3).astype(np.float32) * 0.05, axis=1) + pose


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rtol * float(np.abs(want).max()))


def test_rifke_matches_jax_and_round_trips():
    joints = walk(0)
    feats = rifke.joints_to_rifke(torch.as_tensor(joints))
    close(feats, jrifke.joints_to_rifke(jnp.asarray(joints)))
    assert feats.shape == (3, 24, 1 + 21 * 3 + 1 + 2)
    back = rifke.rifke_to_joints(feats)
    close(back, jrifke.rifke_to_joints(jnp.asarray(feats.numpy())))
    # joints come back up to the floor height and the first frame's XZ and yaw
    again = rifke.joints_to_rifke(back)
    close(again, feats.numpy(), 1e-4)
    for name in ("get_floor", "get_forward_direction"):
        close(getattr(rifke, name)(torch.as_tensor(joints)),
              getattr(jrifke, name)(jnp.asarray(joints)))
    parts = rifke.rifke_extract(feats)
    for got, want in zip(parts, jrifke.rifke_extract(jnp.asarray(feats.numpy()))):
        close(got, want)


@pytest.mark.parametrize("as_tensor", [True, False])
def test_ape_ave_matches_jax(as_tensor):
    pred, gt = walk(1, B=2), walk(2, B=2)
    lengths = np.array([24, 9])
    ours, ref = ApeAveMetrics(), JApeAve()
    for _ in range(2):  # accumulates over updates
        wrap = torch.as_tensor if as_tensor else (lambda a: a)
        ours.update(wrap(pred), wrap(gt), lengths)
        ref.update(pred, gt, lengths)
    got, want = ours.compute(), ref.compute()
    assert set(got) == set(want) == {f"{m}_{q}" for m in ("APE", "AVE")
                                     for q in ("root", "traj", "pose", "joints")}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert ours.count_frames == 2 * lengths.sum() and ours.count_seq == 4
    assert ApeAveMetrics().compute() == {}
