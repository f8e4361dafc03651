"""The port's CUDA kernels against their plain versions on the card.

Marked `gpu`: each test needs an NVIDIA card with nvcc and skips without
one (a CUDA kernel has no interpret mode). Run on the card with
`python -m pytest tests/test_torch_gpu.py -m gpu`. Shapes are small but
exercise the kernels' edges: PointNet point tiles (64 points) and clusters
of 2 tiles filled partly or not at all, at batch 1 and 3;
for both DDIM kernels, batches that fill their last cluster of 4 samples
partly or not at all (1, 3, 5, 17, 64), with and without CFG; the MD
kernel at 1 and 3 condition tokens (the interactee-only and the
image-conditioned configs; their launch plan fits at both guidances); the token
kernel at 1, 3 and 8 condition tokens (up to 20 token rows a cluster) and at
the action-to-motion shape (text width 256, no emb_proj); both DDIM kernels
at 2 and 10 latent tokens (their general instances) and the token counts
they refuse; a SEE-ME model with the token-concat stack (`md_trans=False`,
the stage-1 ego presets') through kernel 5 at 1-3 condition tokens; kernel
5 with 2, 4 and 8 heads and at feed-forward widths 512 and 1024 (MLD's
published denoiser at batch 64: one wave of 13 clusters of 5 samples in
its wide layout), its one-head launch plans as before the wide layout, the
head counts it refuses; and widths that do not split into the cluster's column slices. The GCN
kernels: one hidden graph conv against its f32 version at the cell's width
and at 128 and 192 (row tiles filled partly), and EgoHMR's `sample` through
them against the plain path on the card at the CLI's tiny widths and at the
cell's (B = 64, GCN 1024 x 4, 50 steps), their launch count, and the widths
they refuse. A stage-2 train step on the
card agrees with the same step on the CPU. Both PointNet kernels again at
hidden width 256 (128 points a CTA), at batch 1, 3 and 64 and tiles filled
partly or not at all, and the ProHMR-Scene and EgoHMR evaluation paths on
the card against the CPU at their CLIs' tiny sizes. The text-to-motion
model's sampling at the shipped guidance 1.0 is one token-kernel launch
over 64 condition rows; so is the action-to-motion model's, with 12 and 40
classes, at guidance 1.0 and 7.5. The fused PointNet's backward at both widths
agrees with the eager module's autograd. Host-to-device prefetching gives
the host batches bitwise.
"""

import contextlib
import dataclasses
import math

import pytest
import torch

from seeme_tpu_torch.config.a2m import mld_humanact12
from seeme_tpu_torch.config.humanml3d import mld_humanml3d

from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data import egohmr_images as images
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.diffusion.schedulers import DiffusionSchedule
from seeme_tpu_torch.models.denoiser import Denoiser
from seeme_tpu_torch.models.egohmr import EgoHmr, EgoHmrConfig
from seeme_tpu_torch.models.prohmr import ProHMRConfig, ProHMRScene
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.models.a2m import A2MSystem
from seeme_tpu_torch.models.t2m import T2MSystem
from seeme_tpu_torch.nn.init import init_parameters_, perturb_parameters_
from seeme_tpu_torch.nn.pointnet import ResnetPointnet
from seeme_tpu_torch.ops import _build
from seeme_tpu_torch.ops import denoiser_fused as dfu
from seeme_tpu_torch.ops import gcn_fused as gfu
from seeme_tpu_torch.ops import pointnet_fused as pfu
from seeme_tpu_torch.ops import split_precision
from seeme_tpu_torch.train.loop import train_step
from seeme_tpu_torch.train.state import make_optimizer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def seeded(module, seed, device):
    init_parameters_(module, torch.Generator().manual_seed(seed))
    perturb_parameters_(module, torch.Generator().manual_seed(seed + 100))
    return module.requires_grad_(False).eval().to(device)


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("batch,points", [(3, 1000), (3, 77), (3, 64), (3, 65), (3, 129),
                                          (1, 64), (1, 65), (1, 129), (1, 1000)])
def test_pointnet_blocks(cuda, batch, points):
    """Both kernels against their plain versions at the tile (64 points) and
    cluster (2 tiles) edges: one tile, a ragged second, a ragged third (an
    odd tile count, so the grid's last cluster holds a CTA past the last
    tile), and batch 1."""
    net = seeded(ResnetPointnet(out_dim=64, hidden_dim=512), 1, cuda)
    w = pfu.pointnet_weights(net)
    pts = torch.randn(batch, points, 3, generator=torch.Generator().manual_seed(2)).to(cuda)
    n_in, n_split = pfu.fused_input_block.launches, pfu.fused_split_block.launches
    args = [w[n] for n in ("wpos", "bpos", "w0", "b0", "w1", "b1", "ws")]
    in_split = tuple(w[f"{n}.split"] for n in pfu.INPUT_SPLIT)
    out, pooled = pfu.fused_input_block(pts, *args, split=in_split)
    ref, ref_pooled = pfu.fused_input_block_plain(pts, *args)
    assert rel_err(out, ref) < 1e-4 and rel_err(pooled, ref_pooled) < 1e-4
    split = [w[f"block_1.{n}"] for n in ("w0x", "w0p", "b0", "w1", "b1", "wsx", "wsp")]
    sp_split = tuple(w[f"block_1.{n}.split"] for n in pfu.BLOCK_SPLIT)
    out2, pooled2 = pfu.fused_split_block(ref, ref_pooled, *split, split=sp_split)
    ref2, ref_pooled2 = pfu.fused_split_block_plain(ref, ref_pooled, *split)
    assert rel_err(out2, ref2) < 1e-4 and rel_err(pooled2, ref_pooled2) < 1e-4
    full = pfu.pointnet_forward(w, pts)
    assert rel_err(full, net(pts)) < 1e-4
    assert pfu.fused_input_block.launches == n_in + 2
    assert pfu.fused_split_block.launches == n_split + 4


def check_blocks(net, w, pts):
    """Both kernels and the whole encode against their plain versions."""
    args = [w[n] for n in ("wpos", "bpos", "w0", "b0", "w1", "b1", "ws")]
    in_split = tuple(w[f"{n}.split"] for n in pfu.INPUT_SPLIT)
    out, pooled = pfu.fused_input_block(pts, *args, split=in_split)
    ref, ref_pooled = pfu.fused_input_block_plain(pts, *args)
    assert rel_err(out, ref) < 1e-4 and rel_err(pooled, ref_pooled) < 1e-4
    del out, pooled
    split = [w[f"block_1.{n}"] for n in ("w0x", "w0p", "b0", "w1", "b1", "wsx", "wsp")]
    sp_split = tuple(w[f"block_1.{n}.split"] for n in pfu.BLOCK_SPLIT)
    out2, pooled2 = pfu.fused_split_block(ref, ref_pooled, *split, split=sp_split)
    ref2, ref_pooled2 = pfu.fused_split_block_plain(ref, ref_pooled, *split)
    assert rel_err(out2, ref2) < 1e-4 and rel_err(pooled2, ref_pooled2) < 1e-4
    del out2, ref2, ref
    assert rel_err(pfu.pointnet_forward(w, pts), net(pts)) < 1e-4


@pytest.mark.parametrize("batch,points", [(3, 1000), (3, 77), (3, 128), (3, 129), (3, 257),
                                          (1, 64), (1, 128), (1, 385), (1, 1000),
                                          (64, 1000), (64, 20000)])
def test_pointnet_blocks_width_256(cuda, batch, points):
    """Both kernels at H = 256, the ProHMR-Scene and EgoHMR scene encoders'
    width (128 points a CTA, two warpgroups of 64 points each): fewer points
    than a tile, one tile, a ragged second and third (an odd tile count
    leaves the grid's last cluster a CTA past the last tile), batch 1, and
    the full-width shape."""
    net = seeded(ResnetPointnet(out_dim=512, hidden_dim=256), 11, cuda)
    w = pfu.pointnet_weights(net)
    pts = torch.randn(batch, points, 3, generator=torch.Generator().manual_seed(12)).to(cuda)
    n_in, n_split = pfu.fused_input_block.launches, pfu.fused_split_block.launches
    check_blocks(net, w, pts)
    assert pfu.fused_input_block.launches == n_in + 2
    assert pfu.fused_split_block.launches == n_split + 4


def test_pointnet_launch_at_both_widths(cuda):
    for hidden, tile in ((512, 64), (256, 128)):
        for input_block in (True, False):
            info = pfu.launch_info(input_block, hidden)
            assert info["tile"] == tile == pfu.TILE[hidden] and info["cluster"] == 2, info
            assert info["smem_bytes"] <= 232448 and info["active_clusters"] >= 1, info
    w = pfu.pointnet_weights(seeded(ResnetPointnet(64, 128), 13, cuda))
    args = [w[n] for n in ("wpos", "bpos", "w0", "b0", "w1", "b1", "ws")]
    before = pfu.fused_input_block.launches
    with pytest.raises(ValueError, match="hidden width 128"):
        pfu.fused_input_block(torch.randn(2, 64, 3, device=cuda), *args,
                              split=tuple(w[f"{n}.split"] for n in pfu.INPUT_SPLIT))
    with pytest.raises(ValueError, match="hidden width 128"):
        pfu.launch_info(True, 128)
    assert pfu.fused_input_block.launches == before


def hmr_batch(device):
    dm = images.EgoHmrImageDataModule(n_pts=256, img_size=64, smpl=synthetic_smpl(256))
    batch = next(dm.batches("test", 4, shuffle=False))
    return to_torch(batch, device)


@pytest.mark.parametrize("hidden", [256, 512])
def test_pointnet_backward_matches_plain_twin(cuda, hidden):
    """The fused PointNet's backward on the card (kernels forward, the eager
    recompute backward in chunks of 16 rows) against the eager module's own
    autograd over the same chunks, B = 20 (chunks of 16 and 4), 300 points:
    every parameter's and the points' gradient within 1e-3 of its max |g|,
    and one launch of each block's forward. (Over one unchunked batch the
    products round differently, and a max over points whose top two values
    are that close sends its gradient to the other point.)"""
    net = seeded(ResnetPointnet(64, hidden_dim=hidden), 5, cuda).requires_grad_(True)
    g = torch.Generator().manual_seed(6)
    points = torch.randn(20, 300, 3, generator=g).to(cuda).requires_grad_(True)
    proj = torch.randn(20, 64, generator=g).to(cuda)
    before = pfu.fused_input_block.launches, pfu.fused_split_block.launches
    (pfu.FusedPointnet()(net, points) * proj).sum().backward()
    assert (pfu.fused_input_block.launches - before[0],
            pfu.fused_split_block.launches - before[1]) == (1, 3)
    tensors = (*net.parameters(), points)
    got = [t.grad.clone() for t in tensors]
    for t in tensors:
        t.grad = None
    for rows in torch.split(torch.arange(20, device=cuda), pfu.BATCH_CHUNK):
        (net(points[rows]) * proj[rows]).sum().backward()
    for a, t in zip(got, tensors):
        assert float((a - t.grad).abs().max()) <= 1e-3 * float(t.grad.abs().max())


def test_prohmr_forward_step_matches_cpu(cuda):
    """`forward_step` at the CLI's tiny size, three samples with shared base
    noise: the card (PointNet kernels at H = 256, input block 1, split
    block 3) within 1e-3 of each output's max on the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = ProHMRConfig(flow_hidden=128, flow_depth=1, num_test_samples=3)
    noise = torch.randn(4, 2, 144, generator=torch.Generator().manual_seed(4))
    outs = {}
    for device in ("cpu", cuda):
        model = seeded(ProHMRScene(cfg, synthetic_smpl(256), device=device), 14, device)
        before = pfu.fused_input_block.launches, pfu.fused_split_block.launches
        outs[str(device)] = model.forward_step(hmr_batch(device), noise=noise.to(device))
        launched = (pfu.fused_input_block.launches - before[0],
                    pfu.fused_split_block.launches - before[1])
        assert launched == ((0, 0) if device == "cpu" else (1, 3))
    for k, v in outs["cpu"].items():
        assert rel_err(outs["cuda"][k].cpu(), v) < 1e-3, k


def test_egohmr_sample_matches_cpu(cuda):
    """The whole 10-step sampling at the CLI's tiny size with injected
    noise: the card within 1e-3 of the CPU, the visibility mask equal, the
    scene encoded once (input block 1, split block 3)."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = EgoHmrConfig(gcn_hid_dim=128, gcn_layers=1, num_train_timesteps=100,
                       timestep_respacing="ddim10")
    g = torch.Generator().manual_seed(5)
    x_init, noise = torch.randn(4, 144, generator=g), torch.randn(10, 4, 144, generator=g)
    outs = {}
    for device in ("cpu", cuda):
        model = seeded(EgoHmr(cfg, synthetic_smpl(256), device=device), 15, device)
        before = pfu.fused_input_block.launches, pfu.fused_split_block.launches
        outs[str(device)] = model.sample(hmr_batch(device), x_init=x_init.to(device),
                                         noise=noise.to(device))
        launched = (pfu.fused_input_block.launches - before[0],
                    pfu.fused_split_block.launches - before[1])
        assert launched == ((0, 0) if device == "cpu" else (1, 3))
    cpu, card = outs["cpu"], outs["cuda"]
    assert torch.equal(cpu["vis_mask_smpl"], card["vis_mask_smpl"].cpu())
    for k in ("pred_x_start", "pred_keypoints_3d", "pred_vertices"):
        assert rel_err(card[k].cpu(), cpu[k]) < 1e-3, k


GCN_TINY = dict(gcn_hid_dim=128, gcn_layers=1, num_train_timesteps=100,
                timestep_respacing="ddim10")   # test_egohmr.py --tiny


def tiled_batch(batch, n):
    """`batch` with every tensor's rows repeated up to n."""
    if isinstance(batch, dict):
        return {k: tiled_batch(v, n) for k, v in batch.items()}
    if torch.is_tensor(batch) and batch.ndim > 0:
        reps = -(-n // batch.shape[0])
        return batch.repeat(reps, *[1] * (batch.ndim - 1))[:n].contiguous()
    return batch


@pytest.mark.parametrize("batch,hidden", [(64, 1024), (3, 1024), (1, 128), (5, 192)])
def test_gcn_conv_kernel(cuda, batch, hidden):
    """One hidden graph conv launch (a residual block's second: residual
    added, f32 rows kept) on rows laid out by `tile_rows` against the f32
    conv, mix, scale, shift, ReLU and residual: within 1e-5 of max |out|
    (split TF32); its hi/lo rows are `tile_rows` of its f32 rows bitwise."""
    g = torch.Generator().manual_seed(batch + hidden)
    H, tiles = hidden, gfu.row_tiles(2 * batch)
    rows = tiles * gfu.TILE_ROWS

    def draw(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=g)).to(cuda)

    x, resid = draw(rows, H), draw(rows, H)
    W = draw(2, H, H, scale=1 / math.sqrt(2 * H))
    M, scale, shift = draw(24, H, scale=0.1, shift=1.0), draw(H, scale=0.1, shift=1.0), draw(H)
    adj = (torch.rand(24, 24, generator=g) / 12).to(cuda)
    eye = torch.eye(24, device=cuda)
    diag, off = torch.diagonal(adj), adj * (1 - eye)
    flat = torch.cat([off.reshape(-1), diag]).contiguous()
    out = resid.clone()
    out_hl = torch.empty(tiles, H // gfu.KS, 2 * gfu.TILE_ROWS, gfu.KS, device=cuda)
    a, packed = gfu.tile_rows(x), gfu.pack_weight(W)
    _build.check(_build.load_library().gcn_conv(
        a.data_ptr(), packed.data_ptr(), M.data_ptr(), flat.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), out.data_ptr(), out.data_ptr(), out_hl.data_ptr(), tiles, H,
        _build.stream_ptr(cuda)), "gcn_conv")
    torch.cuda.synchronize()
    h0, h1 = (x @ W[0]).reshape(-1, 24, H), (x @ W[1]).reshape(-1, 24, H)
    mixed = diag[:, None] * (M * h0) + off @ (M * h1)
    want = torch.relu(scale * mixed + shift).reshape(rows, H) + resid
    assert rel_err(out, want) <= 1e-5
    assert torch.equal(out_hl, gfu.tile_rows(out))


@pytest.mark.parametrize("size", ["tiny", "cell"])
def test_egohmr_gcn_kernels_match_the_plain_path(cuda, size):
    """`EgoHmr.sample` through the GCN kernels against the plain path (the
    eager module and `ddpm_step`, `gcn_fused_plain`) on the card from the
    same state and noise, weights drawn as the cell draws them and rot6d
    statistics about the rest pose: at the CLI's tiny widths (B = 4, GCN
    128 x 1, 10 steps) and the cell's (B = 64, 1024 x 4, 50 steps), the pose
    within 1e-4 of its max, joints and vertices within 2e-4 (the cell's
    limits); (2 x gcn_layers + 2) launches a step and for the final
    prediction."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = EgoHmrConfig(**GCN_TINY) if size == "tiny" else EgoHmrConfig()
    B = 4 if size == "tiny" else 64
    model = EgoHmr(cfg, synthetic_smpl(256), device=cuda)
    split_precision.draw_like_the_cell_(model, 7)
    batch = tiled_batch(hmr_batch(cuda), B)
    S = model.sample_schedule.num_train_timesteps
    g = torch.Generator().manual_seed(8)
    x_init, noise = torch.randn(B, 144, generator=g).to(cuda), torch.randn(S, B, 144, generator=g)
    noise = noise.to(cuda)
    with torch.no_grad():
        enc, vis = model.encode(batch), model.visibility_mask(batch)
        plain = gfu.ReverseBatch(model, None, enc, vis)
        x = x_init
        for i, t in enumerate(range(S - 1, -1, -1)):
            x = gfu.gcn_fused_plain(plain, x, t, noise[i] if t > 0 else None)
        pose = gfu.gcn_fused_plain(plain, x)
        model.body_rep_mean.copy_(torch.tensor([1.0, 0, 0, 1, 0, 0], device=cuda).repeat(24))
        model.body_rep_std.fill_(0.15 / float(pose.pow(2).mean().sqrt()))
        want = model(batch, x, torch.zeros(B, dtype=torch.long, device=cuda),
                     eval_with_uncond=True, enc=enc, pred_x0=pose)
    before = gfu.gcn_fused.launches
    got = model.sample(batch, x_init=x_init, noise=noise)
    assert gfu.gcn_fused.launches - before == (2 * cfg.gcn_layers + 2) * (S + 1)
    for k, tol in (("pred_x_start", 1e-4), ("pred_keypoints_3d", 2e-4), ("pred_vertices", 2e-4)):
        assert rel_err(got[k], want[k]) <= tol, k


def test_gcn_kernels_refuse_bad_input(cuda):
    """A hidden width that is not a multiple of 64 (96) is refused before any
    launch, by the model's sampling and by the launcher; a state of another
    type or shape by the wrapper."""
    before = gfu.gcn_fused.launches
    model = EgoHmr(EgoHmrConfig(**{**GCN_TINY, "gcn_hid_dim": 96}), synthetic_smpl(256),
                   device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        model.sample(hmr_batch(cuda))
    with pytest.raises(ValueError, match="multiple of 64"):
        _build.check(_build.load_library().gcn_conv(*[None] * 9, 1, 96,
                                                    _build.stream_ptr(cuda)), "gcn_conv")
    model = EgoHmr(EgoHmrConfig(**GCN_TINY), synthetic_smpl(256), device=cuda)
    batch = hmr_batch(cuda)
    with torch.no_grad():
        rb = model._fused_gcn.batch(model, model.encode(batch), model.visibility_mask(batch))
    for bad in (torch.randn(4, 144, device=cuda).double(), torch.randn(3, 144, device=cuda)):
        with pytest.raises(ValueError, match=r"must be \(4, 144\) float32"):
            gfu.gcn_fused(rb, bad, 5)
    assert gfu.gcn_fused.launches == before


BATCHES = [1, 3, 5, 17, 64]  # the last cluster of 4 samples partly filled or full


@pytest.mark.parametrize("guidance", [1.0, 2.5])
@pytest.mark.parametrize("batch", BATCHES)
def test_ddim_kernel(cuda, batch, guidance):
    den = seeded(Denoiser((1, 256), ff_size=128, num_layers=5), 3, cuda)
    sd = den.state_dict()
    g = torch.Generator().manual_seed(4)
    z0 = torch.randn(batch, 1, 256, generator=g).to(cuda)
    cond = torch.randn((2 if guidance > 1 else 1) * batch, 2, 256, generator=g).to(cuda)
    sched = (DiffusionSchedule(), 10)
    before = dfu.ddim_fused.launches
    z = dfu.ddim_fused(sd, cond, z0, *sched, num_layers=5, guidance_scale=guidance)
    assert dfu.ddim_fused.launches == before + 1
    ref = dfu.ddim_fused_plain(sd, cond, z0, *sched, num_layers=5, guidance_scale=guidance)
    assert rel_err(z, ref) < 1e-3
    before = dfu.ddim_fused_grid.launches
    grid = dfu.ddim_fused_grid(sd, cond, z0, *sched, num_layers=5, guidance_scale=guidance)
    assert dfu.ddim_fused_grid.launches == before + 1
    assert torch.equal(grid, z)  # the same CUDA kernel on the same inputs


@pytest.mark.parametrize("guidance", [1.0, 2.5])
@pytest.mark.parametrize("n_cond", [1, 3])
@pytest.mark.parametrize("batch", [3, 64])
def test_ddim_kernel_condition_tokens(cuda, batch, n_cond, guidance):
    """Kernel 3 at the token counts of `mld_interactee` (1) and
    `mld_egobody_image` (3), against its plain version."""
    den = seeded(Denoiser((1, 256), ff_size=128, num_layers=5), 3, cuda)
    sd = den.state_dict()
    g = torch.Generator().manual_seed(5)
    z0 = torch.randn(batch, 1, 256, generator=g).to(cuda)
    cond = torch.randn((2 if guidance > 1 else 1) * batch, n_cond, 256, generator=g).to(cuda)
    weights = dfu.KernelWeights(sd, 5)
    info = dfu.cluster_launch(True, batch, n_cond, weights, guidance)
    assert info["cluster"] == 8 and info["active_clusters"] >= 1
    assert info["smem_bytes"] <= 227 * 1024
    sched = (DiffusionSchedule(), 10)
    z = dfu.ddim_fused(sd, cond, z0, *sched, num_layers=5, guidance_scale=guidance, weights=weights)
    ref = dfu.ddim_fused_plain(sd, cond, z0, *sched, num_layers=5, guidance_scale=guidance)
    assert rel_err(z, ref) < 1e-3


@pytest.mark.parametrize("guidance", [1.0, 2.5])
@pytest.mark.parametrize("tokens", [2, 10])
@pytest.mark.parametrize("batch", [3, 17])
def test_ddim_kernel_multi_token(cuda, batch, tokens, guidance):
    """Kernel 3's general instance at 2 and 10 latent tokens (the weights do
    not depend on the token count), both MD entries, against the plain
    version; one launch each, counted under its token count; the launch
    plan within the card's shared memory."""
    den = seeded(Denoiser((tokens, 256), ff_size=128, num_layers=5), 3, cuda)
    sd = den.state_dict()
    g = torch.Generator().manual_seed(9)
    z0 = torch.randn(batch, tokens, 256, generator=g).to(cuda)
    cond = torch.randn((2 if guidance > 1 else 1) * batch, 2, 256, generator=g).to(cuda)
    weights = dfu.KernelWeights(sd, 5)
    info = dfu.cluster_launch(True, batch, 2, weights, guidance, tokens=tokens)
    cap = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    assert info["cluster"] == 8 and 1 <= info["samples"] and info["smem_bytes"] <= cap
    sched = (DiffusionSchedule(), 10)
    before = dfu.ddim_fused.launches_by_tokens.get(tokens, 0)
    z = dfu.ddim_fused(sd, cond, z0, *sched, num_layers=5, guidance_scale=guidance,
                       weights=weights)
    assert dfu.ddim_fused.launches_by_tokens[tokens] == before + 1 and z.shape == z0.shape
    ref = dfu.ddim_fused_plain(sd, cond, z0, *sched, num_layers=5, guidance_scale=guidance)
    assert rel_err(z, ref) < 1e-3
    grid = dfu.ddim_fused_grid(sd, cond, z0, *sched, num_layers=5, guidance_scale=guidance,
                               weights=weights)
    assert torch.equal(grid, z)


@pytest.mark.parametrize("tokens,guidance,text_dim", [(2, 1.0, 768), (2, 7.5, 768),
                                                      (10, 1.0, 768), (10, 7.5, 768),
                                                      (2, 1.0, 256), (10, 1.0, 256)])
@pytest.mark.parametrize("batch", [3, 17])
def test_ddim_tok_kernel_multi_token(cuda, batch, tokens, guidance, text_dim):
    """Kernel 5's general instance at 2 and 10 latent tokens, one condition
    token, at the T2M shape (text 768) and the shipped preset's (256); at
    10 tokens under CFG a sample is 24 rows and a cluster carries one."""
    sd = t2m_denoiser(cuda, text_dim)
    g = torch.Generator().manual_seed(10)
    z0 = torch.randn(batch, tokens, 256, generator=g).to(cuda)
    cond = torch.randn((2 if guidance > 1 else 1) * batch, 1, text_dim, generator=g).to(cuda)
    if guidance > 1:
        cond[:batch] = 0.0
    weights = dfu.KernelWeights(sd, 5, md_trans=False)
    info = dfu.cluster_launch(False, batch, 1, weights, guidance, tokens=tokens)
    assert info["samples"] == 1 or tokens < 10 or guidance == 1.0
    sched = (DiffusionSchedule(), 10)
    before = dfu.ddim_fused_tok.launches_by_tokens.get(tokens, 0)
    z = dfu.ddim_fused_tok(sd, cond, z0, *sched, num_layers=5, guidance_scale=guidance,
                           weights=weights)
    assert dfu.ddim_fused_tok.launches_by_tokens[tokens] == before + 1 and z.shape == z0.shape
    ref = dfu.ddim_fused_plain(sd, cond, z0, *sched, num_layers=5, guidance_scale=guidance,
                               md_trans=False)
    assert rel_err(z, ref) < 1e-3


@pytest.mark.parametrize("condition,tokens,guidance", [((), 1, 1.0), ((), 2, 2.5),
                                                        (("interactee", "scene"), 1, 2.5),
                                                        (("interactee", "scene"), 2, 1.0),
                                                        (("interactee", "scene", "image"), 2,
                                                         2.5)])
def test_seeme_token_concat_on_kernel5(cuda, condition, tokens, guidance):
    """A SEE-ME model with `md_trans=False` (the stage-1 ego presets' stack)
    at full width samples through kernel 5, once a call, counted under its
    token count, at 1, 2 and 3 condition tokens; the features within 1e-3
    of its plain version's decoded."""
    data = SyntheticEgoDataset(5, 60, scene_points=256, with_image="image" in condition,
                               image_size=64, seed=0)
    cfg = SeeMeConfig(latent_dim=(tokens, 256), md_trans=False, condition=condition,
                      guidance_scale=guidance, scene_points=256)
    system = seeded(SeeMeSystem(cfg, synthetic_smpl(256), data.mean, data.std, device=cuda,
                                seed=1), 2, cuda)
    batch = to_torch(data.batch(0, 5), cuda)
    cond = system.encode_conditioning(batch)
    z0 = torch.randn(5, tokens, 256, generator=torch.Generator().manual_seed(11)).to(cuda)
    before = dfu.ddim_fused_tok.launches_by_tokens.get(tokens, 0)
    md_before = dfu.ddim_fused.launches
    feats = system.sample_from_cond(cond, z_init=z0)
    assert dfu.ddim_fused_tok.launches_by_tokens[tokens] == before + 1
    assert dfu.ddim_fused.launches == md_before
    sd = system.kernel_operands()[0]
    z = dfu.ddim_fused_plain(sd, cond, z0, system.schedule, cfg.num_inference_timesteps,
                             cfg.num_layers, guidance, md_trans=False)
    assert rel_err(feats, system.vae.decode(z, cfg.motion_length)) < 1e-3


def test_multi_token_limits_raise(cuda):
    """A token count past what a cluster holds raises, naming the limit,
    and launches nothing: kernel 5's 30 token rows a sample (31 without
    CFG, 32 under it), kernel 3's shared memory a CTA."""
    sched = (DiffusionSchedule(), 4)
    tok = t2m_denoiser(cuda)
    before = dfu.ddim_fused_tok.launches
    for cond, T, g, match in ((torch.zeros(2, 1, 768, device=cuda), 29, 1.0,
                               "29 latent and 1 condition tokens: kernel 5 takes at most 30 "
                               "token rows a sample"),
                              (torch.zeros(4, 1, 768, device=cuda), 14, 7.5,
                               "14 latent and 1 condition tokens under CFG: kernel 5 takes at "
                               "most 30")):
        with pytest.raises(ValueError, match=match):
            dfu.ddim_fused_tok(tok, cond, torch.randn(2, T, 256, device=cuda), *sched,
                               num_layers=5, guidance_scale=g)
    assert dfu.ddim_fused_tok.launches == before
    md = seeded(Denoiser((1, 256), ff_size=128, num_layers=5), 3, cuda).state_dict()
    before = dfu.ddim_fused.launches
    with pytest.raises(ValueError, match="40 latent and 2 condition tokens under CFG: one "
                                         "sample's rows need more shared memory"):
        dfu.ddim_fused(md, torch.randn(4, 2, 256, device=cuda),
                       torch.randn(2, 40, 256, device=cuda), *sched, num_layers=5,
                       guidance_scale=2.5)
    assert dfu.ddim_fused.launches == before


def test_cluster_launch(cuda):
    """Both DDIM kernels launch as clusters of 8 CTAs, and carry enough
    samples a cluster that a batch of 17 runs in one wave of the clusters
    that fit on the card at once; at MLD's widths (9 layers, 4 heads, ff
    1024) and at each width kernel 5's wide layout takes, batch 64 under CFG
    runs in one wave of 13 clusters of 5 samples (30 token rows)."""
    md = dfu.KernelWeights(seeded(Denoiser((1, 256), ff_size=128, num_layers=5), 3,
                                  cuda).state_dict(), 5)
    tok = dfu.KernelWeights(t2m_denoiser(cuda), 5, md_trans=False)
    wide = [dfu.KernelWeights(mld_denoiser(cuda, heads, ff), 9, md_trans=False, num_heads=heads)
            for heads, ff in ((4, 1024), (2, 512), (1, 1024))]
    for md_trans, w, n_cond, guidance, batch in (
            (True, md, 2, 1.0, 17), (True, md, 2, 2.5, 17), (False, tok, 1, 1.0, 17),
            (False, tok, 1, 7.5, 17), *((False, w, 1, 7.5, 64) for w in wide)):
        info = dfu.cluster_launch(md_trans, batch, n_cond, w, guidance)
        clusters = info["grid"] // info["cluster"]
        assert info["cluster"] == dfu.CLUSTER_CTAS == 8 and info["grid"] % 8 == 0
        assert 1 <= clusters <= info["active_clusters"] and info["smem_bytes"] <= 227 * 1024
        if batch == 64:
            assert info["samples"] == 5 and clusters == 13


def mld_denoiser(device, heads=4, ff=1024, layers=9, text_dim=768):
    """A token-concat denoiser at MLD's published HumanML3D widths by
    default (latent 256, 9 layers, 4 heads, ff 1024, text 768)."""
    den = Denoiser((1, 256), ff_size=ff, num_layers=layers, num_heads=heads,
                   text_encoded_dim=text_dim, md_trans=False)
    return seeded(den, 12, device).state_dict()


# heads, ff, layers, batch, guidance, latent tokens, steps: MLD's published
# denoiser at batch 64 (the wide layout, 13 clusters of 5 samples); 2 heads
# at ff 512; one head at ff 1024; several heads in the narrow layout (ff <=
# 256); 3 rows a cluster (batch 1 without CFG); the general instance (T = 2)
HEAD_CASES = [(4, 1024, 9, 64, 7.5, 1, 50), (2, 512, 9, 64, 7.5, 1, 10),
              (2, 512, 5, 17, 1.0, 1, 10), (1, 1024, 9, 5, 7.5, 1, 10),
              (4, 128, 5, 17, 7.5, 1, 10), (8, 256, 5, 3, 7.5, 1, 10),
              (4, 1024, 9, 1, 1.0, 1, 10), (4, 1024, 9, 3, 7.5, 2, 10)]


@pytest.mark.parametrize("heads,ff,layers,batch,guidance,tokens,steps", HEAD_CASES)
def test_ddim_tok_kernel_heads(cuda, heads, ff, layers, batch, guidance, tokens, steps):
    """Kernel 5 with several heads, and with a feed-forward wider than the
    latent (split by depth over the cluster), against its plain twin at the
    same head count: one launch, within 1e-3 of max |z|."""
    sd = mld_denoiser(cuda, heads, ff, layers)
    g = torch.Generator().manual_seed(13)
    z0 = torch.randn(batch, tokens, 256, generator=g).to(cuda)
    cond = torch.randn((2 if guidance > 1 else 1) * batch, 1, 768, generator=g).to(cuda)
    if guidance > 1:
        cond[:batch] = 0.0
    weights = dfu.KernelWeights(sd, layers, md_trans=False, num_heads=heads)
    sched = (DiffusionSchedule(), steps)
    before = dfu.ddim_fused_tok.launches
    z = dfu.ddim_fused_tok(sd, cond, z0, *sched, num_layers=layers, guidance_scale=guidance,
                           weights=weights)
    assert dfu.ddim_fused_tok.launches == before + 1 and z.shape == z0.shape
    ref = dfu.ddim_fused_plain(sd, cond, z0, *sched, num_layers=layers, guidance_scale=guidance,
                               md_trans=False, num_heads=heads)
    assert rel_err(z, ref) < 1e-3


# (batch, latent tokens, condition tokens, guidance) -> (samples a cluster,
# shared memory bytes a CTA) that kernel 5 planned at one head, 5 layers and
# ff 128 before it took several heads and the wide layout (NVIDIA H100 80GB
# HBM3, 15 clusters of 8 at once); the narrow layout keeps them
ONE_HEAD_PLANS = {(1, 1, 1, 1.0): (1, 26672), (1, 1, 1, 7.5): (1, 52304),
                  (1, 1, 3, 1.0): (1, 43120), (1, 1, 3, 7.5): (1, 85200),
                  (1, 1, 8, 1.0): (1, 84368), (1, 1, 8, 7.5): (1, 147232),
                  (1, 2, 1, 1.0): (1, 36928), (1, 2, 1, 7.5): (1, 71808),
                  (1, 2, 3, 1.0): (1, 53392), (1, 2, 3, 7.5): (1, 104736),
                  (1, 2, 8, 1.0): (1, 94704), (1, 2, 8, 7.5): (1, 164816),
                  (1, 10, 1, 1.0): (1, 119360), (1, 10, 1, 7.5): (1, 203904),
                  (1, 10, 3, 1.0): (1, 135952), (1, 10, 8, 1.0): (1, 158128),
                  (17, 1, 1, 1.0): (2, 53328), (17, 1, 1, 7.5): (2, 104592),
                  (17, 1, 3, 1.0): (2, 86224), (17, 1, 3, 7.5): (2, 149904),
                  (17, 1, 8, 1.0): (2, 148256), (17, 1, 8, 7.5): (1, 147232),
                  (17, 2, 1, 1.0): (2, 73856), (17, 2, 1, 7.5): (2, 143616),
                  (17, 2, 3, 1.0): (2, 106784), (17, 2, 3, 7.5): (2, 184896),
                  (17, 2, 8, 1.0): (2, 166864), (17, 2, 8, 7.5): (1, 164816),
                  (17, 10, 1, 1.0): (2, 214144), (17, 10, 1, 7.5): (1, 203904),
                  (17, 10, 3, 1.0): (1, 135952), (17, 10, 8, 1.0): (1, 158128),
                  (64, 1, 1, 1.0): (5, 133312), (64, 1, 1, 7.5): (5, 230768),
                  (64, 1, 3, 1.0): (5, 189952), (64, 1, 3, 7.5): (3, 224864),
                  (64, 1, 8, 1.0): (3, 222384), (64, 1, 8, 7.5): (1, 147232),
                  (64, 2, 1, 1.0): (5, 164160), (64, 2, 1, 7.5): (3, 190848),
                  (64, 2, 3, 1.0): (4, 188992), (64, 2, 3, 7.5): (2, 184896),
                  (64, 2, 8, 1.0): (2, 166864), (64, 2, 8, 7.5): (1, 164816),
                  (64, 10, 1, 1.0): (2, 214144), (64, 10, 1, 7.5): (1, 203904),
                  (64, 10, 3, 1.0): (1, 135952), (64, 10, 8, 1.0): (1, 158128)}


def test_one_head_plans_unchanged(cuda):
    """The narrow layout plans every one-head shape as before: the same
    samples a cluster and shared memory a CTA."""
    tok = dfu.KernelWeights(t2m_denoiser(cuda), 5, md_trans=False)
    got = {(b, t, nc, g): (lambda i: (i["samples"], i["smem_bytes"]))(
               dfu.cluster_launch(False, b, nc, tok, g, tokens=t))
           for b, t, nc, g in ONE_HEAD_PLANS}
    assert got == ONE_HEAD_PLANS


def t2m_denoiser(device, text_dim=768):
    """The text-to-motion denoiser at full width: latent 256, ff 128, 5
    layers, text width 768 (emb_proj); at text width 256 there is no
    emb_proj, the action-to-motion shape."""
    den = Denoiser((1, 256), ff_size=128, num_layers=5, text_encoded_dim=text_dim,
                   md_trans=False)
    sd = seeded(den, 6, device).state_dict()
    assert ("emb_proj.1.weight" in sd) == (text_dim != 256)
    return sd


@pytest.mark.parametrize("n_cond,guidance,batch,text_dim",
                         [(1, g, b, 768) for g in (1.0, 7.5) for b in BATCHES]
                         + [(3, 1.0, 5, 768), (3, 7.5, 5, 768), (8, 7.5, 5, 768), (8, 1.0, 3, 768)]
                         + [(1, g, b, 256) for g in (1.0, 7.5) for b in (3, 64)])
def test_ddim_tok_kernel(cuda, n_cond, guidance, batch, text_dim):
    sd = t2m_denoiser(cuda, text_dim)
    g = torch.Generator().manual_seed(7)
    z0 = torch.randn(batch, 1, 256, generator=g).to(cuda)
    cond = torch.randn((2 if guidance > 1 else 1) * batch, n_cond, text_dim, generator=g).to(cuda)
    if guidance > 1:
        cond[:batch] = 0.0  # the uncond half, as T2MSystem.sample builds it
    sched = (DiffusionSchedule(), 10)
    before = dfu.ddim_fused_tok.launches
    z = dfu.ddim_fused_tok(sd, cond, z0, *sched, num_layers=5, guidance_scale=guidance)
    assert dfu.ddim_fused_tok.launches == before + 1
    ref = dfu.ddim_fused_plain(sd, cond, z0, *sched, num_layers=5, guidance_scale=guidance,
                               md_trans=False)
    assert rel_err(z, ref) < 1e-3


@pytest.mark.parametrize("text_dim", [768, 256])
def test_t2m_guidance_one_sample_is_one_launch(cuda, text_dim):
    """`T2MSystem.sample` at the shipped guidance 1.0 (`mld_humanml3d`): a
    condition batch of 64 rows, no CFG doubling, 50 steps, one token-kernel
    launch, within 1e-3 of max |z| of the plain version and its features
    within 1e-3 of max |features| of the decoded plain latents; text width
    768 (`T2MConfig()`, with emb_proj) and 256 (the preset, without)."""
    cfg = dataclasses.replace(mld_humanml3d().model, text_encoded_dim=text_dim)
    system = T2MSystem(cfg, torch.zeros(263), torch.ones(263), device=cuda, seed=3)
    perturb_parameters_(system, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    text = torch.randn(64, 1, text_dim, generator=g).to(cuda)
    z0 = torch.randn(64, 1, 256, generator=g).to(cuda)
    before = dfu.ddim_fused_tok.launches
    feats = system.sample(text, z_init=z0)
    assert dfu.ddim_fused_tok.launches == before + 1
    sd, _ = system.kernel_operands()
    z_plain = dfu.ddim_fused_plain(sd, text, z0, system.schedule, 50, 5, 1.0, md_trans=False)
    z_kernel = dfu.ddim_fused_tok(sd, text, z0, system.schedule, 50, 5, 1.0,
                                  weights=system.kernel_operands()[1])
    assert rel_err(z_kernel, z_plain) < 1e-3
    assert rel_err(feats, system.vae.decode(z_plain, cfg.max_len)) < 1e-3


@pytest.mark.parametrize("classes,guidance", [(12, 1.0), (12, 7.5), (40, 1.0), (40, 7.5)])
def test_a2m_sample_is_one_kernel_launch(cuda, classes, guidance):
    """`A2MSystem.sample` at the shipped width (latent 256, ff 128, one
    action token, no emb_proj) on 64 labels: one token-kernel launch over
    64 or 128 condition rows, the latent within 1e-3 of max |z| of the
    plain version, the features within 1e-3 of the decoded plain latent."""
    cfg = dataclasses.replace(mld_humanact12().model, num_classes=classes,
                              guidance_scale=guidance)
    system = A2MSystem(cfg, device=cuda, seed=3)
    perturb_parameters_(system, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    labels = torch.randint(0, classes, (64,), generator=g).to(cuda)
    z0 = torch.randn(64, 1, 256, generator=g).to(cuda)
    before = dfu.ddim_fused_tok.launches
    feats = system.sample(labels, z_init=z0)
    assert dfu.ddim_fused_tok.launches == before + 1 and feats.shape == (64, 60, 150)
    cond = system.embed_action(labels)
    if guidance > 1:
        cond = torch.cat([torch.zeros_like(cond), cond])
    sd, weights = system.kernel_operands()
    z_plain = dfu.ddim_fused_plain(sd, cond, z0, system.schedule, 50, 5, guidance,
                                   md_trans=False)
    z_kernel = dfu.ddim_fused_tok(sd, cond, z0, system.schedule, 50, 5, guidance,
                                  weights=weights)
    assert rel_err(z_kernel, z_plain) < 1e-3
    assert rel_err(feats, system.vae.decode(z_plain, cfg.num_frames)) < 1e-3


def test_ddim_tok_refuses_bad_input(cuda):
    sd = t2m_denoiser(cuda)
    z0 = torch.randn(2, 1, 256, device=cuda)
    sched = (DiffusionSchedule(), 4)
    before = dfu.ddim_fused_tok.launches
    for cond, match in ((torch.randn(2, 9, 768, device=cuda), "condition tokens"),
                        (torch.randn(2, 1, 768, device=cuda).double(), "contiguous float32"),
                        (torch.randn(2, 2, 768, device=cuda)[:, :1], "contiguous"),
                        (torch.randn(3, 1, 768, device=cuda), "for batch 2")):
        with pytest.raises(ValueError, match=match):
            dfu.ddim_fused_tok(sd, cond, z0, *sched, num_layers=5)
    with pytest.raises(ValueError, match="do not match"):
        dfu.ddim_fused_tok(sd, torch.randn(2, 1, 768, device=cuda), z0, *sched, num_layers=5,
                           weights=dfu.KernelWeights(sd, 3, md_trans=False))
    for heads in (3, 16):  # 256 / 3 is no whole width; 16 heads are 16 columns wide
        with pytest.raises(ValueError, match="kernel 5 takes heads whose width"):
            dfu.ddim_fused_tok(sd, torch.randn(2, 1, 768, device=cuda), z0, *sched,
                               num_layers=5, num_heads=heads)
    assert dfu.ddim_fused_tok.launches == before


def test_kernel_wrappers_refuse_bad_input(cuda):
    w = pfu.pointnet_weights(seeded(ResnetPointnet(64, 512), 5, cuda))
    pts = torch.randn(2, 40, 3, device=cuda)
    args = [w[n] for n in ("wpos", "bpos", "w0", "b0", "w1", "b1", "ws")]
    in_split = tuple(w[f"{n}.split"] for n in pfu.INPUT_SPLIT)
    before = pfu.fused_input_block.launches, pfu.fused_split_block.launches
    with pytest.raises(ValueError, match="contiguous float32"):
        pfu.fused_input_block(pts.double(), *args, split=in_split)
    with pytest.raises(ValueError, match="contiguous float32"):
        pfu.fused_input_block(pts.transpose(0, 1).contiguous().transpose(0, 1), *args,
                              split=in_split)
    # the split weights: missing, f32, a wrong shape, not contiguous
    x = torch.randn(2, 40, 512, device=cuda)
    pooled = x.amax(dim=1)
    split = [w[f"block_1.{n}"] for n in ("w0x", "w0p", "b0", "w1", "b1", "wsx", "wsp")]
    sp_split = tuple(w[f"block_1.{n}.split"] for n in pfu.BLOCK_SPLIT)
    with pytest.raises(ValueError, match="split bf16 product weights"):
        pfu.fused_input_block(pts, *args)
    with pytest.raises(ValueError, match="split bf16 product weights"):
        pfu.fused_split_block(x, pooled, *split)
    with pytest.raises(ValueError, match="contiguous bfloat16"):
        pfu.fused_input_block(pts, *args, split=(in_split[0].float(), *in_split[1:]))
    with pytest.raises(ValueError, match="expected shape"):
        pfu.fused_input_block(pts, *args, split=(in_split[1], in_split[1], in_split[2]))
    with pytest.raises(ValueError, match="expected shape"):
        pfu.fused_split_block(x, pooled, *split, split=(in_split[0], *sp_split[1:]))
    with pytest.raises(ValueError, match="contiguous bfloat16"):
        pfu.fused_split_block(x, pooled, *split,
                              split=(*sp_split[:2], sp_split[2].transpose(0, 1).contiguous()
                                     .transpose(0, 1)))
    assert before == (pfu.fused_input_block.launches, pfu.fused_split_block.launches)
    # feed-forward width 96: 12 columns a CTA, 3 float4 quads, which do not divide a warp
    sched = (DiffusionSchedule(), 4)
    z0 = torch.randn(2, 1, 256, device=cuda)
    md = seeded(Denoiser((1, 256), ff_size=96, num_layers=3), 8, cuda).state_dict()
    tok = seeded(Denoiser((1, 256), ff_size=96, num_layers=3, md_trans=False), 9,
                 cuda).state_dict()
    before = dfu.ddim_fused.launches, dfu.ddim_fused_grid.launches, dfu.ddim_fused_tok.launches
    for fn, sd in ((dfu.ddim_fused, md), (dfu.ddim_fused_grid, md), (dfu.ddim_fused_tok, tok)):
        with pytest.raises(ValueError, match="width 96 does not split"):
            fn(sd, torch.randn(2, 1, 256, device=cuda), z0, *sched, num_layers=3)
    assert before == (dfu.ddim_fused.launches, dfu.ddim_fused_grid.launches,
                      dfu.ddim_fused_tok.launches)


@pytest.mark.parametrize("guidance", [1.0, 2.5])
def test_stage2_train_step_matches_cpu(cuda, guidance):
    """One stage-2 step (raw scene through the PointNet kernels, and at
    guidance 2.5 with the CFG masks) on the card and on the CPU with the
    same draws and dropout 0: the loss within 1e-4 relative, each gradient
    within 1e-3 of its tensor's max |g| (1e-8 for one that is zero but for
    rounding), and the updated parameters alike where the gradient's sign is
    settled (a first AdamW step moves an element by about lr * sign(g))."""
    torch.backends.cudnn.allow_tf32 = False
    data = SyntheticEgoDataset(3, 60, scene_points=64, seed=0)
    cfg = SeeMeConfig(latent_dim=(1, 32), ff_size=16, num_layers=3, scene_points=64,
                      scene_feat_dim=32, dropout=0.0, guidance_scale=guidance)
    runs = {}
    for device in ("cpu", cuda):
        system = seeded(SeeMeSystem(cfg, synthetic_smpl(256), data.mean, data.std,
                                    device=device, seed=1), 2, device)
        runs[str(device)] = (system, *make_optimizer("diffusion", system, lr=1e-3))
    batch = to_torch(data.batch(0, 3), "cpu")
    draws = runs["cpu"][0].loss_draws("diffusion", batch, torch.Generator().manual_seed(3))
    before = pfu.fused_input_block.launches
    loss = {}
    for device, (system, opt, sched) in runs.items():
        loss[device] = train_step(system, "diffusion", opt, sched, 0,
                                  {k: v.to(device) for k, v in batch.items()},
                                  draws={k: v.to(device) for k, v in draws.items()})["total"]
    assert pfu.fused_input_block.launches == before + 1
    assert abs(loss["cuda"] - loss["cpu"]) <= 1e-4 * abs(loss["cpu"])
    card = dict(runs["cuda"][0].named_parameters())
    for name, p in runs["cpu"][0].named_parameters():
        q = card[name]
        assert (p.grad is None) == (q.grad is None), name
        if p.grad is None:
            continue
        gap = (p.grad - q.grad.cpu()).abs()
        assert float(gap.max()) <= max(1e-3 * float(p.grad.abs().max()), 1e-8), name
        firm = (p.grad.abs() > 1e-6) & (p.grad.abs() > 10 * gap)
        d = (p.detach() - q.detach().cpu()).abs()
        assert bool((d[firm] <= 2e-6).all()) and bool((d <= 2e-3 + 2e-6).all()), name


@pytest.mark.parametrize("size", [1, 2, 4])
def test_prefetch_to_device_equals_the_host_batches(cuda, size):
    """Pinned staging, the side stream's copies and the consumer's wait: every
    prefetched batch equals its host batch bitwise, captions untouched, and a
    kernel that reads each batch at once sees the copied data."""
    import numpy as np

    from seeme_tpu_torch.data.prefetch import prefetch_to_device

    rng = np.random.RandomState(0)
    host = [{"scene": rng.randn(8, 20000, 3).astype(np.float32),
             "length": np.arange(8, dtype=np.int32), "text": [f"c{i}"] * 8}
            for i in range(5)]
    for b, got in zip(host, prefetch_to_device(iter(host), cuda, size=size)):
        assert got["scene"].is_cuda and got["text"] == b["text"]
        seen = got["scene"] * 1.0  # a kernel on the consumer's stream, right away
        assert torch.equal(seen.cpu(), torch.as_tensor(b["scene"]))
        assert torch.equal(got["scene"].cpu(), torch.as_tensor(b["scene"]))
        assert torch.equal(got["length"].cpu(), torch.as_tensor(b["length"]))


def block0_out(enc, points):
    """(net, x) of the scene encoder's first block, per point: its fc_0
    output, where its second ReLU decides, and the output the first
    max-pool takes."""
    h = enc.fc_pos_0(points)
    b0 = enc.block_0
    net = b0.fc_0(torch.relu(h))
    return net, b0.shortcut(h) + b0.fc_1(torch.relu(net))


def plant_near_ties(enc, points, generator, pool_ties: int = 64) -> None:
    """In place: for every channel of `block_0.fc_0`, its bias moved so that
    one random point's input to the ReLU is 0 in float64; then for
    `pool_ties` channels of the first max-pool (sample c % B), a point of the
    lower half moved along its gradient until its float64 value equals the
    channel's max, and one coordinate set to the float32 neighbour that
    comes closest. In float32 each planted value sits within rounding of its
    ReLU's 0 or of its pool's max."""
    B, N, _ = points.shape
    H = enc.hidden_dim
    twin = ResnetPointnet(enc.fc_c.out_features, H).double()
    with torch.no_grad():
        twin.load_state_dict(enc.state_dict())
        pick = torch.randint(0, B * N, (H,), generator=generator)
        net = block0_out(twin, points.double())[0].reshape(B * N, H)
        enc.block_0.fc_0.bias -= net[pick, torch.arange(H)].float()
        twin.load_state_dict(enc.state_dict())
    taken = set(pick.tolist())

    def value(p, c):
        return block0_out(twin, p.double())[1][..., c]

    for c in range(pool_ties):
        b = c % B
        with torch.no_grad():
            col = value(points[b], c)
        top = float(col.max())
        for j in torch.argsort(col, descending=True)[N // 2:].tolist():
            if b * N + j in taken:
                continue
            start = points[b, j].double().requires_grad_(True)
            d, = torch.autograd.grad(value(start, c), start)
            start, d = start.detach(), d / d.norm()
            with torch.no_grad():
                hi = 1e-2
                while float(value(start + hi * d, c)) < top and hi < 1e2:
                    hi *= 2
                if float(value(start + hi * d, c)) < top:
                    continue
                lo = 0.0
                for _ in range(80):
                    mid = (lo + hi) / 2
                    lo, hi = (mid, hi) if float(value(start + mid * d, c)) < top else (lo, mid)
                q = (start + hi * d).float()
                near = [q.clone() for _ in range(27)]
                for i, w in enumerate(near):
                    w[i // 9] = q[i // 9] + (i % 9 - 4) * torch.finfo(torch.float32).eps * \
                        max(abs(float(q[i // 9])), 1e-3)
                points[b, j] = min(near, key=lambda w: abs(float(value(w, c)) - top))
            taken.add(b * N + j)
            break


def test_replayed_scene_decisions_hold_planted_ties(cuda):
    """`chip_smoke.relu_decisions` under `chip_smoke.compare_step`, the gate
    of phases 28-29's card-vs-CPU train steps, on EgoHMR's scene encoder
    (hidden 256, out 512; B = 8, 1024 points, one AdamW step of a seeded
    projection of its output). Near ties are planted (`plant_near_ties`:
    256 ReLU inputs of `block_0` at 0, 64 first-pool maxima tied), so the
    card and the CPU decide some of them apart. Without the replay of the
    card's decisions in the encoder's recompute in backward (all the
    encoder's ReLUs and max-pools; it calls no other) the gate fails; with
    it the step passes; with it and an error of 2e-3 of max |g| planted in
    one element of `block_0.fc_0.weight`'s gradient the gate fails on that
    tensor."""
    import chip_smoke as smoke

    from seeme_tpu_torch.models.egohmr import SCENE_HIDDEN

    class Scene(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.scene_enc = ResnetPointnet(EgoHmrConfig().scene_feat_dim,
                                            hidden_dim=SCENE_HIDDEN)
            self._fused = pfu.FusedPointnet()

        def encode_scene(self, pcd):
            return self._fused(self.scene_enc, pcd)

    g = torch.Generator().manual_seed(7)
    points = torch.rand(8, 1024, 3, generator=g) * 2 - 1
    proj = torch.randn(8, EgoHmrConfig().scene_feat_dim, generator=g)
    start = seeded(Scene(), 8, "cpu")
    plant_near_ties(start.scene_enc, points, g)
    sd = start.state_dict()

    def step(device, masks=None, record=False, hook=None):
        m = Scene().to(device)
        m.load_state_dict(sd)
        m.requires_grad_(True)
        if hook is not None:
            m.scene_enc.block_0.fc_0.weight.register_hook(hook)
        opt = torch.optim.AdamW(m.parameters(), lr=smoke.TRAIN_LR)
        replay = (smoke.relu_decisions(m, masks, record=record) if masks is not None
                  else contextlib.nullcontext())
        with replay:
            loss = (m.encode_scene(points.to(device)) * proj.to(device)).sum()
            loss.backward()
        opt.step()
        return m, float(loss.detach())

    masks = []
    card, loss_card = step(cuda, masks, record=True)
    with torch.no_grad():
        net, x = block0_out(start.scene_enc, points)
    kinds = [k for k, _ in masks]
    assert kinds.count("amax") == 4 and kinds.count("relu") == 12, kinds
    relu_flips = int((masks[1][1] != (net > 0)).sum())
    first_pool = masks[kinds.index("amax")][1]
    pool_flips = int((first_pool != (x == x.amax(1, keepdim=True))).sum())
    print(f"card vs CPU decisions apart: {relu_flips} of block_0's ReLUs, "
          f"{pool_flips} entries of the first pool's mask")
    assert relu_flips > 0

    bare, loss_bare = step("cpu")
    with pytest.raises(SystemExit, match="gradient differs card vs CPU") as failed:
        smoke.compare_step("unreplayed", bare, card, loss_bare, loss_card, smoke.TRAIN_LR)
    print(f"    unreplayed: {failed.value}")
    cpu, loss_cpu = step("cpu", masks)
    smoke.compare_step("replayed", cpu, card, loss_cpu, loss_card, smoke.TRAIN_LR)

    grad = cpu.scene_enc.block_0.fc_0.weight.grad
    error = torch.zeros_like(grad)
    error[3, 5] = 2e-3 * float(grad.abs().max())
    wrong, loss_wrong = step("cpu", masks, hook=lambda gr: gr + error)
    with pytest.raises(SystemExit,
                       match=r"scene_enc\.block_0\.fc_0\.weight gradient differs") as failed:
        smoke.compare_step("planted error", wrong, card, loss_wrong, loss_card, smoke.TRAIN_LR)
    print(f"    planted error: {failed.value}")
