"""The port's text-to-motion slice against the JAX package on the CPU in
f32: RIC recovery, the synthetic HumanML3D data, the MR metrics, and the
whole path `T2MSystem.sample(z_init=...)` -> `feats2joints` -> `MRMetrics`
against the JAX `T2MSystem.sample(z_init=...)` -> the data module's
`feats2joints` -> its `MRMetrics`, at a small width (latent 1 x 32, text 48,
3 layers, 24 frames, 5 DDIM steps). The same numpy noise goes to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.config.loader import Config
from seeme_tpu.core import ric as j_ric
from seeme_tpu.data.humanml import HumanML3DDataModule
from seeme_tpu.eval import t2m_metrics as j_metrics
from seeme_tpu.models.t2m import T2MConfig as JConfig
from seeme_tpu.models.t2m import T2MSystem as JSystem
from seeme_tpu_torch.convert import from_jax_params
from seeme_tpu_torch.core import ric
from seeme_tpu_torch.data.humanml import SyntheticT2MDataset, feats2joints
from seeme_tpu_torch.eval.t2m_metrics import MRMetrics, procrustes_align
from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
from seeme_tpu_torch.nn.init import perturb_parameters_
from tools.convert_checkpoint import convert_mld_checkpoint

B, W, TEXT, T, STEPS = 3, 32, 48, 24, 5
SMALL = dict(latent_dim=(1, W), ff_size=16, num_layers=3, text_encoded_dim=TEXT, max_len=T,
             num_inference_timesteps=STEPS)


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def datamodule():
    cfg = Config({"DEBUG": True, "DATASET": {"SAMPLER": {"MAX_LEN": T, "MIN_LEN": 8}},
                  "model": {"denoiser": {"params": {"text_encoded_dim": TEXT}}}})
    return HumanML3DDataModule(cfg)


def test_quaternion_helpers():
    q, r, v = rand(1, 5, 4), rand(2, 5, 4), rand(3, 5, 3)
    for ours, ref in ((ric.qinv(torch.as_tensor(q)), j_ric.qinv(q)),
                      (ric.qmul(torch.as_tensor(q), torch.as_tensor(r)), j_ric.qmul(q, r)),
                      (ric.qrot(torch.as_tensor(q), torch.as_tensor(v)), j_ric.qrot(q, v))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_recover_from_ric():
    data = rand(4, 2, T, 263) * 0.3
    quat, pos = ric.recover_root_rot_pos(torch.as_tensor(data))
    jquat, jpos = j_ric.recover_root_rot_pos(jnp.asarray(data))
    np.testing.assert_allclose(quat.numpy(), np.asarray(jquat), atol=1e-5)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=1e-5)
    joints = ric.recover_from_ric(torch.as_tensor(data), 22)
    assert joints.shape == (2, T, 22, 3)
    np.testing.assert_allclose(joints.numpy(), np.asarray(j_ric.recover_from_ric(data, 22)),
                               atol=1e-5)


def test_synthetic_dataset_matches_jax(datamodule):
    """The same seed gives the same arrays as the JAX package's dataset, and
    the data module's renorm -> RIC recovery."""
    ours = SyntheticT2MDataset(33, T, 8, seed=2, text_dim=TEXT)
    ref = datamodule._sets["test"]
    np.testing.assert_array_equal(ours.mean, ref.mean)
    np.testing.assert_array_equal(ours.std, ref.std)
    batch = ours.batch(0, 33)
    for i in (0, 17, 32):
        for k in ("motion", "length", "text_emb"):
            np.testing.assert_array_equal(batch[k][i], ref[i][k])
    train = SyntheticT2MDataset(32, T, 8, seed=0, text_dim=TEXT)
    np.testing.assert_array_equal(train.mean, datamodule.mean)
    joints = feats2joints(torch.as_tensor(batch["motion"][:4]), torch.as_tensor(train.mean),
                          torch.as_tensor(train.std))
    np.testing.assert_allclose(joints.numpy(),
                               np.asarray(datamodule.feats2joints(batch["motion"][:4])),
                               atol=1e-5)


def test_procrustes_and_mr_metrics_match_jax():
    S1, S2 = rand(5, 22, 3), rand(6, 22, 3)
    np.testing.assert_allclose(procrustes_align(S1, S2), j_metrics.procrustes_align(S1, S2),
                               rtol=1e-6, atol=1e-7)
    pred, gt, lengths = rand(7, 3, T, 22, 3), rand(8, 3, T, 22, 3), np.array([T, 9, 2])
    ours, ref = MRMetrics(), j_metrics.MRMetrics()
    for m in (ours, ref):
        m.update(pred, gt, lengths)
        m.update(pred[:1] * 0.5, gt[:1], lengths[:1])
    got, want = ours.compute(), ref.compute()
    assert set(got) == set(want) == {"MPJPE", "PAMPJPE", "ACCEL"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def build(guidance, datamodule):
    system = T2MSystem(T2MConfig(guidance_scale=guidance, **SMALL), datamodule.mean,
                       datamodule.std, device="cpu", seed=1)
    perturb_parameters_(system, torch.Generator().manual_seed(2))
    jsystem = JSystem(JConfig(guidance_scale=guidance, dropout=0.0, **SMALL))
    params = jax.tree.map(jnp.asarray, convert_mld_checkpoint(
        {k: v.numpy() for k, v in system.state_dict().items()}))
    return system, jsystem, params


@pytest.mark.parametrize("guidance", [1.0, 7.5])
def test_t2m_slice_matches_jax_composition(guidance, datamodule):
    system, jsystem, params = build(guidance, datamodule)
    batch = SyntheticT2MDataset(33, T, 8, seed=2, text_dim=TEXT).batch(0, B)
    z0 = rand(9, B, 1, W)
    text, lengths = batch["text_emb"], batch["length"]

    feats = system.sample(torch.as_tensor(text), lengths=torch.as_tensor(lengths),
                          z_init=torch.as_tensor(z0))
    jfeats = jax.jit(lambda p, t, n, z: jsystem.sample(p, t, jax.random.PRNGKey(0), lengths=n,
                                                       z_init=z))(
        params, jnp.asarray(text), jnp.asarray(lengths), jnp.asarray(z0))
    assert feats.shape == (B, T, 263)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats),
                               atol=1e-4 * float(np.abs(jfeats).max()))

    joints = system.feats_to_joints(feats)
    jjoints = np.asarray(datamodule.feats2joints(jfeats))
    np.testing.assert_allclose(joints.numpy(), jjoints, atol=1e-4 * float(np.abs(jjoints).max()))

    ours, ref = MRMetrics(), j_metrics.MRMetrics()
    ours.update(joints.numpy(), system.feats_to_joints(torch.as_tensor(batch["motion"])).numpy(),
                lengths)
    ref.update(jjoints, np.asarray(datamodule.feats2joints(batch["motion"])), lengths)
    got, want = ours.compute(), ref.compute()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_state_dict_is_a_reference_checkpoint(datamodule):
    """`convert_mld_checkpoint` takes every port key (md_trans inferred as
    False), and `from_jax_params` inverts it exactly."""
    system, _, params = build(7.5, datamodule)
    sd = system.state_dict()
    assert "self_attn" in params["denoiser"]["params"]["encoder"]["middle"]  # a plain layer
    back = from_jax_params(jax.tree.map(np.asarray, params))
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)


def test_from_jax_params_takes_the_jax_init_tree(datamodule):
    """The tree `T2MSystem.init_params` builds maps onto every port
    parameter, shape for shape (strict load)."""
    system, jsystem, _ = build(7.5, datamodule)
    shapes = jax.eval_shape(jsystem.init_params, jax.random.PRNGKey(5))
    tree = jax.tree.map(lambda s: np.full(s.shape, 0.5, np.float32), shapes)
    system.load_state_dict(from_jax_params(tree), strict=True)
    assert all(bool((p == 0.5).all()) for p in system.parameters())


def test_kernel_operands_follow_the_parameters(datamodule):
    system, _, _ = build(7.5, datamodule)
    other, _, _ = build(1.0, datamodule)
    perturb_parameters_(other, torch.Generator().manual_seed(3))
    first = system.kernel_operands()[1]
    assert first is system.kernel_operands()[1] and not first.md_trans
    system.load_state_dict(other.state_dict())
    assert all(torch.equal(a, b) for a, b in zip(system.kernel_operands()[1].tensors,
                                                 other.kernel_operands()[1].tensors))


def test_unported_modes_raise(datamodule):
    """The token modes, `vae_type="no"` and `trans_dec` are ported now
    (`tests/test_torch_t2m_train.py`); what is still refused: a VAE stage
    or a reconstruction without a VAE, and settings that name no mode."""
    novae = T2MSystem(T2MConfig(**{**SMALL, "vae_type": "no", "arch": "trans_dec"}),
                      datamodule.mean, datamodule.std, device="cpu")
    batch = {"motion": torch.zeros(2, T, 263), "length": torch.tensor([T, 9])}
    with pytest.raises(ValueError, match="vae stage is undefined"):
        novae.vae_loss(batch)
    with pytest.raises(ValueError, match="needs a VAE"):
        novae.reconstruct(batch)
    for kw, match in (({"vae_type": "actor"}, "vae_type"), ({"arch": "mdm"}, "arch")):
        with pytest.raises(ValueError, match=match):
            T2MSystem(T2MConfig(**SMALL, **kw), datamodule.mean, datamodule.std, device="cpu")
