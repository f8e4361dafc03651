"""The port's sampling slice as a whole against the JAX composition, and the
weight converters in both directions, on the CPU in f32.

`SeeMeSystem.sample_from_cond` of the JAX package has no `z_init` hook, so
the reference is composed here: `encode_conditioning`, then
`ddim_sample(z_init=...)` over the flax `Denoiser`, then `vae.decode`, then
`eval_fk`, then `ego_sequence_metrics`. The same numpy noise goes to both.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.core.smpl import synthetic_smpl as j_synthetic_smpl
from seeme_tpu.diffusion.sampling import ddim_sample
from seeme_tpu.eval.metrics import ego_sequence_metrics as j_metrics
from seeme_tpu.models.seeme import SeeMeConfig as JConfig
from seeme_tpu.models.seeme import SeeMeSystem as JSystem
from seeme_tpu_torch.convert import from_jax_params
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.eval.metrics import ego_sequence_metrics
from seeme_tpu_torch.models import seeme as seeme_module
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.nn.init import perturb_parameters_
from seeme_tpu_torch.ops import denoiser_fused as dfu
from tools.convert_checkpoint import convert_mld_checkpoint

B, W, STEPS, POINTS = 3, 32, 5, 64
SMALL = dict(latent_dim=(1, W), ff_size=16, num_layers=3, num_inference_timesteps=STEPS,
             scene_points=POINTS, scene_feat_dim=W)


def build(guidance):
    data = SyntheticEgoDataset(B, 60, scene_points=POINTS, seed=0)
    system = SeeMeSystem(SeeMeConfig(guidance_scale=guidance, **SMALL),
                         synthetic_smpl(256), data.mean, data.std, device="cpu", seed=1)
    perturb_parameters_(system, torch.Generator().manual_seed(2))
    jsystem = JSystem(JConfig(guidance_scale=guidance, **SMALL), j_synthetic_smpl(256),
                      data.mean, data.std)
    params = jax.tree.map(jnp.asarray, convert_mld_checkpoint(
        {k: v.numpy() for k, v in system.state_dict().items()}))
    return data, system, jsystem, params


@pytest.mark.parametrize("guidance", [1.0, 2.5])
def test_slice_matches_jax_composition(guidance):
    data, system, jsystem, params = build(guidance)
    nb = data.batch(0, B)
    tb, jb = to_torch(nb, "cpu"), {k: jnp.asarray(v) for k, v in nb.items()}
    z0 = np.random.RandomState(3).randn(B, 1, W).astype(np.float32)

    cond = system.encode_conditioning(tb)
    jcond = jax.jit(jsystem.encode_conditioning)(params, jb)
    assert cond.shape == ((2 if guidance > 1 else 1) * B, 2, W)
    np.testing.assert_allclose(cond.numpy(), np.asarray(jcond), atol=1e-4)

    feats = system.sample_from_cond(cond, z_init=torch.as_tensor(z0))
    z = ddim_sample(lambda x, t, r: jsystem.denoiser.apply(params["denoiser"], x, t, jcond),
                    jsystem.schedule, jax.random.PRNGKey(0), z0.shape,
                    num_inference_steps=STEPS, guidance_scale=guidance, z_init=z0)
    jfeats = jax.jit(lambda p, z: jsystem.vae.apply(p, z, 60, method=jsystem.vae.decode))(
        params["vae"], z)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats),
                               atol=1e-4 * float(np.abs(jfeats).max()))

    out, jout = system.eval_fk(tb, feats), jax.jit(jsystem.eval_fk)(params, jb, jfeats)
    for k in ("joints_rst", "joints_ref", "joints_int", "quat_rst", "quat_ref"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=1e-5, err_msg=k)

    mask = np.ones((B, 60), bool)
    ours = ego_sequence_metrics(out["joints_rst"], out["joints_ref"], out["quat_rst"],
                                out["quat_ref"], torch.as_tensor(mask))
    ref = j_metrics(jout["joints_rst"], jout["joints_ref"], jout["quat_rst"], jout["quat_ref"],
                    jnp.asarray(mask))
    for k in ours:  # mm-scale values: 1e-3 is a micrometre
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-3)


def test_state_dict_is_a_reference_checkpoint():
    """Every port key is consumed by `convert_mld_checkpoint`, and
    `from_jax_params` inverts it exactly."""
    _, system, _, params = build(1.0)
    sd = system.state_dict()
    back = from_jax_params(jax.tree.map(np.asarray, params))
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)


def test_from_jax_params_takes_the_jax_init_tree():
    """The tree `SeeMeSystem.init_params` builds maps onto every port
    parameter, shape for shape (strict load)."""
    _, system, jsystem, _ = build(1.0)
    shapes = jax.eval_shape(jsystem.init_params, jax.random.PRNGKey(5))
    tree = jax.tree.map(lambda s: np.full(s.shape, 0.5, np.float32), shapes)
    system.load_state_dict(from_jax_params(tree), strict=True)
    assert all(bool((p == 0.5).all()) for p in system.parameters())


def test_kernel_operands_follow_the_parameters():
    """The kernel-layout weight copies are made again after `load_state_dict`
    and after an in-place update, so the PointNet and DDIM paths never run
    on stale weights (results compared exactly)."""
    data = SyntheticEgoDataset(B, 60, scene_points=POINTS, seed=0)
    make = lambda seed: SeeMeSystem(SeeMeConfig(**SMALL), synthetic_smpl(256),  # noqa: E731
                                    data.mean, data.std, device="cpu", seed=seed)
    system, other = make(1), make(5)
    perturb_parameters_(other, torch.Generator().manual_seed(6))
    scene = torch.as_tensor(data.batch(0, B)["scene"])
    rng = np.random.RandomState(7)
    cond = torch.as_tensor(rng.randn(B, 2, W).astype(np.float32))
    z0 = torch.as_tensor(rng.randn(B, 1, W).astype(np.float32))
    before = system.scene_features(scene)
    system.sample_from_cond(cond, z_init=z0)

    system.load_state_dict(other.state_dict())
    assert torch.equal(system.scene_features(scene), other.scene_features(scene))
    assert not torch.equal(system.scene_features(scene), before)
    ours, theirs = system.kernel_operands()[1], other.kernel_operands()[1]
    assert all(torch.equal(a, b) for a, b in zip(ours.tensors, theirs.tensors))
    assert torch.equal(system.sample_from_cond(cond, z_init=z0),
                       other.sample_from_cond(cond, z_init=z0))

    perturb_parameters_(system, torch.Generator().manual_seed(8))
    assert not torch.equal(system.scene_features(scene), other.scene_features(scene))
    assert not torch.equal(system.kernel_operands()[1].tensors[0],
                           other.kernel_operands()[1].tensors[0])


def test_fused_variant_selects_the_ddim_entry():
    """`fused_variant="grid"` routes `sample_from_cond` through
    `ddim_fused_grid` (on the CPU its plain version, as the loop entry's),
    with the loop variant's result; an unknown variant is refused."""
    data = SyntheticEgoDataset(B, 60, scene_points=POINTS, seed=0)
    make = lambda variant: SeeMeSystem(  # noqa: E731
        SeeMeConfig(fused_variant=variant, **SMALL), synthetic_smpl(256), data.mean, data.std,
        device="cpu", seed=1)
    loop, grid = make("loop"), make("grid")
    rng = np.random.RandomState(9)
    cond = torch.as_tensor(rng.randn(B, 2, W).astype(np.float32))
    z0 = torch.as_tensor(rng.randn(B, 1, W).astype(np.float32))
    calls = []
    with mock.patch.object(seeme_module, "ddim_fused_grid",
                           side_effect=lambda *a, **k: calls.append(1) or dfu.ddim_fused_grid(*a, **k)):
        got = grid.sample_from_cond(cond, z_init=z0)
    assert calls == [1]
    assert torch.equal(got, loop.sample_from_cond(cond, z_init=z0))
    with pytest.raises(ValueError, match="fused_variant"):
        make("scan")
