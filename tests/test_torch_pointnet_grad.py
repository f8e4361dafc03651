"""The fused PointNet's backward (`ops/pointnet_fused.py::_FusedPointnetFunction`,
the port of `pointnet_forward_pallas`'s `custom_vjp`) against the JAX
package, on the CPU in f32 where the blocks run their plain versions: the
gradients of a seeded random projection of the output, with respect to
every parameter and the points, against `jax.grad` through the Pallas
kernels in interpret mode and through their XLA twin `_pointnet_forward_xla`,
at both widths the kernels take, within 1e-4 of each tensor's max |g|.
Every route to the fused blocks (the bare wrapper, ProHMR-Scene's and
EgoHMR's `encode_scene`, SEE-ME's scene encoder) now trains its encoder
with that gradient, and SEE-ME's frozen stage 2 still runs.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from seeme_tpu.nn.pointnet import ResnetPointnet as JResnetPointnet
from seeme_tpu.ops import pointnet_pallas
from seeme_tpu_torch.convert import pointnet_state_dict
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.models.egohmr import EgoHmr, EgoHmrConfig
from seeme_tpu_torch.models.prohmr import ProHMRConfig, ProHMRScene
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.nn.pointnet import ResnetPointnet
from seeme_tpu_torch.ops import pointnet_fused as pfu
from seeme_tpu_torch.train.loop import train_step
from seeme_tpu_torch.train.state import make_optimizer

GRAD_RTOL = 1e-4


def jax_pointnet(hidden, out_dim, seed):
    """A flax `ResnetPointnet` tree with every leaf moved off its init (the
    zeroed `fc_1` too), as numpy."""
    params = JResnetPointnet(out_dim=out_dim, hidden_dim=hidden).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, 3)))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rs.randn(*a.shape).astype(np.float32),
                        params)


def port_pointnet(params, hidden, out_dim):
    net = ResnetPointnet(out_dim, hidden_dim=hidden)
    net.load_state_dict({k[len("n."):]: v for k, v in
                         pointnet_state_dict(params["params"], "n").items()})
    return net


def interpreted(fn, *args):
    """`fn` with every `pl.pallas_call` in interpret mode
    (`tests/test_pallas_ops.py:22-31`)."""
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    with mock.patch.object(pointnet_pallas.pl, "pallas_call", patched):
        return fn(*args)


def jax_grads(fn, params, points, proj):
    """d/d(params, points) of sum(fn(params, points) * proj), as the port's
    state dict layout (prefix `n.`) and numpy."""
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(fn(p, x) * proj), argnums=(0, 1)))(
        params, points)
    return {k[len("n."):]: v.numpy() for k, v in
            pointnet_state_dict(jax.tree.map(np.asarray, gp)["params"], "n").items()}, \
        np.asarray(gx)


def assert_grads_match(named, want):
    for name, p in named:
        g = want[name]
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(g).max()), err_msg=name)


@pytest.mark.parametrize("hidden", [256, 512])
def test_backward_matches_jax_custom_vjp(hidden):
    """B = 2, 128 points, out 32: the Function's gradients against the JAX
    `custom_vjp` with its kernels interpreted, and against the XLA twin."""
    params = jax_pointnet(hidden, 32, hidden)
    rs = np.random.RandomState(hidden + 1)
    points = rs.randn(2, 128, 3).astype(np.float32)
    proj = rs.randn(2, 32).astype(np.float32)
    net = port_pointnet(params, hidden, 32)
    x = torch.tensor(points, requires_grad=True)
    out = pfu.FusedPointnet()(net, x)
    (out * torch.as_tensor(proj)).sum().backward()
    for fn in (lambda p, x: interpreted(pointnet_pallas.pointnet_forward_pallas, p, x),
               pointnet_pallas._pointnet_forward_xla):
        want, want_x = jax_grads(fn, jax.tree.map(jnp.asarray, params), jnp.asarray(points),
                                 jnp.asarray(proj))
        assert_grads_match(net.named_parameters(), want)
        np.testing.assert_allclose(x.grad.numpy(), want_x, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(want_x).max()))


def test_backward_recomputes_in_chunks_of_sixteen():
    """B = 37 runs the recompute as chunks of 16, 16 and 5 rows: the
    gradients equal one eager backward's, and a frozen point cloud gets none."""
    torch.manual_seed(0)
    net = ResnetPointnet(16, hidden_dim=16)
    for p in net.parameters():
        p.data += 0.05 * torch.randn_like(p)
    points = torch.randn(37, 40, 3)
    proj = torch.randn(37, 16)
    calls = []
    real = torch.func.functional_call
    with mock.patch.object(torch.func, "functional_call",
                           lambda m, p, a: calls.append(a[0].shape[0]) or real(m, p, a)):
        (pfu.FusedPointnet()(net, points) * proj).sum().backward()
    assert calls == [16, 16, 5] and pfu.BATCH_CHUNK == 16
    got = [p.grad.clone() for p in net.parameters()]
    net.zero_grad()
    (net(points) * proj).sum().backward()
    for g, p in zip(got, net.parameters()):
        torch.testing.assert_close(g, p.grad, rtol=1e-5, atol=1e-6)


def route_encoder(route):
    """(encoder, its route's encode function) on the CPU."""
    small = synthetic_smpl(32)
    if route == "fused":
        net, fused = ResnetPointnet(512, hidden_dim=256), pfu.FusedPointnet()
        return net, lambda pts: fused(net, pts)
    if route == "seeme":
        system = SeeMeSystem(SeeMeConfig(latent_dim=(1, 32), ff_size=16, num_layers=3,
                                         scene_points=64), small, np.zeros(75), np.ones(75),
                             device="cpu")
        net = system.proscene["scene_enc"]
        return net, lambda pts: system._fused_scene(net, pts)
    model = (ProHMRScene(ProHMRConfig(flow_hidden=8, flow_layers=1, flow_depth=1), small,
                         device="cpu") if route == "prohmr"
             else EgoHmr(EgoHmrConfig(gcn_hid_dim=8, gcn_layers=0), small, device="cpu"))
    return model.scene_enc, model.encode_scene


@pytest.mark.parametrize("route", ["fused", "prohmr", "egohmr", "seeme"])
def test_every_route_trains_its_encoder_with_the_jax_gradient(route):
    """The encoder's weights from a JAX tree; the gradient through the
    route matches `jax.grad` of the XLA twin, and one AdamW step moves every
    tensor and rebuilds the route's kernel-layout weights."""
    net, encode = route_encoder(route)
    hidden, out_dim = net.hidden_dim, net.fc_c.out_features
    params = jax_pointnet(hidden, out_dim, 7)
    net.load_state_dict(port_pointnet(params, hidden, out_dim).state_dict())
    rs = np.random.RandomState(8)
    points = rs.randn(2, 100, 3).astype(np.float32)
    proj = rs.randn(2, out_dim).astype(np.float32)
    net.requires_grad_(True)
    (encode(torch.as_tensor(points)) * torch.as_tensor(proj)).sum().backward()
    want, _ = jax_grads(pointnet_pallas._pointnet_forward_xla,
                        jax.tree.map(jnp.asarray, params), jnp.asarray(points), jnp.asarray(proj))
    assert_grads_match(net.named_parameters(), want)
    before = [p.detach().clone() for p in net.parameters()]
    feats = encode(torch.as_tensor(points)).detach()
    torch.optim.AdamW(net.parameters(), lr=1e-3, foreach=True).step()
    assert all(not torch.equal(a, p) for a, p in zip(before, net.parameters()))
    with torch.no_grad():
        assert not torch.equal(encode(torch.as_tensor(points)), feats)  # weights rebuilt


def test_seeme_frozen_stage_two_still_runs():
    """Stage 2 at guidance 2.5 runs the PointNet every step (no cache),
    with the encoder frozen: the step trains, and the encoder gets no
    gradient and stays as it was."""
    data = SyntheticEgoDataset(3, 60, scene_points=64, seed=0)
    system = SeeMeSystem(SeeMeConfig(latent_dim=(1, 32), ff_size=16, num_layers=3,
                                     scene_points=64, scene_feat_dim=32, guidance_scale=2.5,
                                     dropout=0.0),
                         synthetic_smpl(256), data.mean, data.std, device="cpu")
    optimizer, schedule = make_optimizer("diffusion", system)
    before = {k: v.clone() for k, v in system.proscene.state_dict().items()}
    assert not any(p.requires_grad for p in system.proscene.parameters())
    terms = train_step(system, "diffusion", optimizer, schedule, 0,
                       to_torch(data.batch(0, 3), "cpu"), torch.Generator().manual_seed(0))
    assert np.isfinite(terms["total"])
    for k, v in system.proscene.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in system.proscene.parameters())
