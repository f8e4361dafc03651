"""The perception stack's building blocks in the port against the JAX
package, on the CPU in f32: the conditional Glow (forward, inverse,
log-density, sampling with shared noise), the rotations and the pinhole
projection, the respaced cosine schedule and its ancestral DDPM step (with
the MLD schedule's numbers unchanged), the modulated GCN, and the PointNet
at hidden width 256 through the fused blocks' plain versions. Weights go
from the JAX package's own init (perturbed, batch statistics moved off
(0, 1)) to the port through `seeme_tpu_torch/convert.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.core import rotations as jrot
from seeme_tpu.diffusion import schedulers as jsch
from seeme_tpu.flows import glow as jglow
from seeme_tpu.nn.gcn import ModulatedGCN as JGCN
from seeme_tpu.nn.gcn import smpl_adjacency as j_adjacency
from seeme_tpu.nn.pointnet import ResnetPointnet as JPointnet
from seeme_tpu.ops import pointnet_pallas as j_pp
from seeme_tpu_torch.convert import gcn_state_dict, glow_state_dict, pointnet_state_dict
from seeme_tpu_torch.core import rotations as rot
from seeme_tpu_torch.diffusion import schedulers as sch
from seeme_tpu_torch.flows.glow import ConditionalGlow, GlowConfig
from seeme_tpu_torch.nn.gcn import ModulatedGCN, smpl_adjacency
from seeme_tpu_torch.nn.pointnet import ResnetPointnet
from seeme_tpu_torch.ops import pointnet_fused as pfu

GLOW = dict(features=12, hidden_features=32, num_layers=3, num_blocks_per_layer=2,
            context_features=7)  # tests/test_flows.py's flow
B = 8


def rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def perturbed(tree, seed, scale=0.05):
    """Every leaf moved by seeded noise; variances kept positive."""
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    out = []
    for path, leaf in zip(jax.tree_util.tree_flatten_with_path(tree)[0], leaves):
        a = np.asarray(leaf, np.float32)
        noise = (rs.randn(*a.shape) * scale).astype(np.float32)
        name = str(path[0][-1]) if path[0] else ""
        out.append(a + np.abs(noise) if "var" in name else a + noise)
    return jax.tree.unflatten(treedef, out)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def glow_pair():
    cfg = jglow.GlowConfig(**GLOW)
    params = perturbed(jglow.init_glow(jax.random.PRNGKey(0), cfg), 1)
    flow = ConditionalGlow(GlowConfig(**GLOW)).eval()
    sd = {k[len("flow."):]: v for k, v in glow_state_dict(params, "flow").items()}
    flow.load_state_dict(sd, strict=True)
    return cfg, jax.tree.map(jnp.asarray, params), flow


def test_glow_forward_inverse_log_prob(glow_pair):
    cfg, params, flow = glow_pair
    x, ctx = rand(2, B, 12, scale=2.0) + 1.0, rand(3, B, 7)
    z_j, ld_j = jglow.glow_forward(params, cfg, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        z, ld = flow(torch.as_tensor(x), torch.as_tensor(ctx))
        x_back, ld_inv = flow.inverse(z, torch.as_tensor(ctx))
        lp, noise = flow.log_prob(torch.as_tensor(x), torch.as_tensor(ctx))
    assert rel(z.numpy(), z_j) < 1e-4 and rel(ld.numpy(), ld_j) < 1e-4
    xi_j, ldi_j = jglow.glow_inverse(params, cfg, z_j, jnp.asarray(ctx))
    assert rel(x_back.numpy(), xi_j) < 1e-4 and rel(ld_inv.numpy(), ldi_j) < 1e-4
    assert rel(x_back.numpy(), x) < 1e-4  # the inverse inverts
    lp_j, noise_j = jglow.glow_log_prob(params, cfg, jnp.asarray(x), jnp.asarray(ctx))
    assert rel(lp.numpy(), lp_j) < 1e-4 and rel(noise.numpy(), noise_j) < 1e-4


def test_glow_sample_and_log_prob_with_shared_noise(glow_pair):
    cfg, params, flow = glow_pair
    ctx, noise = rand(4, B, 7), rand(5, B, 3, 12)
    s_j, lp_j, n_j = jglow.glow_sample_and_log_prob(params, cfg, 3, jnp.asarray(ctx),
                                                    noise=jnp.asarray(noise))
    with torch.no_grad():
        s, lp, n = flow.sample_and_log_prob(3, torch.as_tensor(ctx), noise=torch.as_tensor(noise))
    assert s.shape == (B * 3, 12) and lp.shape == (B * 3,)
    assert rel(s.numpy(), s_j) < 1e-4 and rel(lp.numpy(), lp_j) < 1e-4
    assert np.array_equal(n.numpy(), np.asarray(n_j))
    # drawn noise: a seeded generator gives the same samples twice
    with torch.no_grad():
        a = flow.sample_and_log_prob(2, torch.as_tensor(ctx), torch.Generator().manual_seed(7))
        b = flow.sample_and_log_prob(2, torch.as_tensor(ctx), torch.Generator().manual_seed(7))
    assert torch.equal(a[0], b[0]) and torch.isfinite(a[1]).all()


def test_glow_masks_match():
    assert np.array_equal(GlowConfig(**GLOW).masks(), jglow.GlowConfig(**GLOW).masks())


@pytest.mark.parametrize("mode", ["prohmr", "diffusion"])
def test_rot6d_to_rotmat_matches_jax(mode):
    x = rand(6, 64, 6)
    want = np.asarray(jrot.rot6d_to_rotmat(jnp.asarray(x), mode=mode))
    got = rot.rot6d_to_rotmat(torch.as_tensor(x), mode=mode).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("with_center,with_rotation", [(True, False), (False, False),
                                                      (True, True)])
def test_perspective_projection_matches_jax(with_center, with_rotation):
    pts = rand(7, 4, 45, 3)
    transl = rand(8, 4, 3) * 0.3 + np.array([0, 0, 3.0], np.float32)
    focal = np.abs(rand(9, 4, 2)) * 100 + 1000
    center = rand(10, 4, 2) * 10 + 500 if with_center else None
    R = np.array(jrot.aa_to_rotmat(jnp.asarray(rand(11, 4, 3)))) if with_rotation else None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    want = np.asarray(jrot.perspective_projection(j(pts), j(transl), j(focal), j(center), j(R)))
    got = rot.perspective_projection(t(pts), t(transl), t(focal), t(center), t(R)).numpy()
    assert got.shape == (4, 45, 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n,spec", [(1000, "ddim50"), (100, "ddim10"), (1000, "250"),
                                    (1000, "10,20,30"), (300, "7,3")])
def test_space_timesteps_exact(n, spec):
    assert np.array_equal(sch.space_timesteps(n, spec), jsch.space_timesteps(n, spec))


@pytest.mark.parametrize("n,spec", [(1000, "ddim50"), (100, "ddim10")])
def test_respaced_cosine_schedule(n, spec):
    kw = dict(num_train_timesteps=n, beta_schedule="squaredcos_cap_v2", prediction_type="sample")
    base_j = jsch.DiffusionSchedule(**kw)
    base = sch.DiffusionSchedule(**kw)
    np.testing.assert_allclose(base.betas, np.asarray(base_j.betas), atol=1e-7, rtol=0)
    np.testing.assert_allclose(base.alphas_cumprod, base_j.alphas_cumprod_np, atol=1e-7, rtol=0)
    j, jmap = jsch.respaced_schedule(base_j, jsch.space_timesteps(n, spec))
    s, smap = sch.respaced_schedule(base, sch.space_timesteps(n, spec))
    assert np.array_equal(smap, jmap) and s.num_train_timesteps == j.num_train_timesteps
    np.testing.assert_allclose(s.betas, np.asarray(j.betas), atol=1e-7, rtol=0)
    np.testing.assert_allclose(s.alphas_cumprod, j.alphas_cumprod_np, atol=1e-7, rtol=0)
    assert s.prediction_type == "sample" and s.beta_schedule == "squaredcos_cap_v2"
    # the ancestral step at every respaced timestep, t = 0 without noise
    x, pred, noise = rand(12, 4, 144), rand(13, 4, 144), rand(14, 4, 144)
    for t in range(s.num_train_timesteps):
        want = np.asarray(j.ddpm_step(jnp.asarray(pred), jnp.asarray(t), jnp.asarray(x),
                                      jnp.asarray(noise)))
        got = s.ddpm_step(torch.as_tensor(pred), t, torch.as_tensor(x), torch.as_tensor(noise))
        assert rel(got.numpy(), want) < 1e-5, t


def test_mld_schedule_unchanged():
    """The MLD default (scaled-linear betas, epsilon prediction) keeps its
    numbers: alphas_cumprod and the DDIM timesteps as the JAX package's,
    and the epsilon x0 as before."""
    s, j = sch.DiffusionSchedule(), jsch.DiffusionSchedule()
    assert s.beta_schedule == "scaled_linear" and s.prediction_type == "epsilon"
    assert np.array_equal(s.alphas_cumprod, j.alphas_cumprod_np)
    assert np.array_equal(s.ddim_timesteps(50), j.ddim_timesteps(50))
    x, eps = rand(15, 2, 1, 8), rand(16, 2, 1, 8)
    want = np.asarray(j.predict_x0(jnp.asarray(eps), 501, jnp.asarray(x)))
    np.testing.assert_allclose(s.predict_x0(torch.as_tensor(eps), 501, torch.as_tensor(x)).numpy(),
                               want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("in_dim,hid,layers", [(50, 128, 1), (40, 32, 2)])
def test_modulated_gcn_matches_jax(in_dim, hid, layers):
    assert np.array_equal(smpl_adjacency(), j_adjacency())
    jgcn = JGCN(adj=j_adjacency(), hid_dim=hid, out_dim=6, num_layers=layers)
    tree = jgcn.init(jax.random.PRNGKey(3), jnp.zeros((2, 24, in_dim)))
    tree = perturbed(tree, 4)
    x = rand(17, 3, 24, in_dim)
    want = np.asarray(jgcn.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    gcn = ModulatedGCN(in_dim, smpl_adjacency(), hid, 6, layers).eval()
    sd = {k[len("g."):]: v for k, v in gcn_state_dict(tree, "g").items()}
    gcn.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = gcn(torch.as_tensor(x)).numpy()
    assert got.shape == (3, 24, 6) and rel(got, want) < 1e-4


@pytest.fixture(scope="module")
def pointnet_256():
    jnet = JPointnet(out_dim=512, hidden_dim=256)
    tree = perturbed(jnet.init(jax.random.PRNGKey(5), jnp.zeros((1, 16, 3))), 6, scale=0.02)
    net = ResnetPointnet(512, hidden_dim=256).eval()
    sd = {k[len("p."):]: v for k, v in pointnet_state_dict(tree["params"], "p").items()}
    net.load_state_dict(sd, strict=True)
    return jnet, jax.tree.map(jnp.asarray, tree), net.requires_grad_(False)


@pytest.mark.parametrize("points", [256, 77])
def test_pointnet_width_256_matches_jax(pointnet_256, points):
    """The fused blocks' plain versions (what the wrappers run for CPU
    tensors) at H = 256 against flax's `ResnetPointnet(hidden_dim=256)` and
    the JAX kernels' XLA twin, and against the port module's own forward."""
    jnet, tree, net = pointnet_256
    pts = rand(18, 2, points, 3)
    w = pfu.pointnet_weights(net)
    assert w["w1"].shape == (256, 256) and w["w1.split"].shape == (16, 512, 16)
    before = (pfu.fused_input_block.launches, pfu.fused_split_block.launches)
    got = pfu.pointnet_forward(w, torch.as_tensor(pts)).numpy()
    assert (pfu.fused_input_block.launches, pfu.fused_split_block.launches) == before
    flax_out = np.asarray(jax.jit(jnet.apply)(tree, jnp.asarray(pts)))
    xla = np.asarray(jax.jit(j_pp._pointnet_forward_xla)(tree, jnp.asarray(pts)))
    assert got.shape == (2, 512)
    assert rel(got, flax_out) < 1e-4 and rel(got, xla) < 1e-4
    assert rel(got, net(torch.as_tensor(pts)).numpy()) < 1e-5
