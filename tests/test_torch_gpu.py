"""The port's CUDA kernels against their plain versions on the card.

Marked `gpu`: each test needs an NVIDIA card with nvcc and skips without
one (a CUDA kernel has no interpret mode). Run on the card with
`python -m pytest tests/test_torch_gpu.py -m gpu`. Shapes are small but
exercise the kernels' edges: a ragged last point tile at two point counts,
a batch that leaves the last DDIM CTA partly empty, the CFG path, and the
token kernel at 1, 3 and 8 condition tokens (up to 20 token rows a CTA).
"""

import pytest
import torch

from seeme_tpu_torch.diffusion.schedulers import DiffusionSchedule
from seeme_tpu_torch.models.denoiser import Denoiser
from seeme_tpu_torch.nn.init import init_parameters_, perturb_parameters_
from seeme_tpu_torch.nn.pointnet import ResnetPointnet
from seeme_tpu_torch.ops import denoiser_fused as dfu
from seeme_tpu_torch.ops import pointnet_fused as pfu

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


@pytest.mark.parametrize("points", [1000, 77])
def test_pointnet_blocks(cuda, points):
    net = seeded(ResnetPointnet(out_dim=64, hidden_dim=512), 1, cuda)
    w = pfu.pointnet_weights(net)
    pts = torch.randn(3, points, 3, generator=torch.Generator().manual_seed(2)).to(cuda)
    n_in, n_split = pfu.fused_input_block.launches, pfu.fused_split_block.launches
    args = [w[n] for n in ("wpos", "bpos", "w0", "b0", "w1", "b1", "ws")]
    out, pooled = pfu.fused_input_block(pts, *args)
    ref, ref_pooled = pfu.fused_input_block_plain(pts, *args)
    assert rel_err(out, ref) < 1e-4 and rel_err(pooled, ref_pooled) < 1e-4
    split = [w[f"block_1.{n}"] for n in ("w0x", "w0p", "b0", "w1", "b1", "wsx", "wsp")]
    out2, pooled2 = pfu.fused_split_block(ref, ref_pooled, *split)
    ref2, ref_pooled2 = pfu.fused_split_block_plain(ref, ref_pooled, *split)
    assert rel_err(out2, ref2) < 1e-4 and rel_err(pooled2, ref_pooled2) < 1e-4
    full = pfu.pointnet_forward(w, pts)
    assert rel_err(full, net(pts)) < 1e-4
    assert pfu.fused_input_block.launches == n_in + 2
    assert pfu.fused_split_block.launches == n_split + 4


@pytest.mark.parametrize("batch,guidance", [(5, 1.0), (3, 2.5)])
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


def t2m_denoiser(device):
    """The text-to-motion denoiser at full width: latent 256, ff 128, 5
    layers, text width 768 (emb_proj)."""
    den = Denoiser((1, 256), ff_size=128, num_layers=5, text_encoded_dim=768, md_trans=False)
    return seeded(den, 6, device).state_dict()


@pytest.mark.parametrize("n_cond,guidance", [(1, 1.0), (1, 7.5), (3, 1.0), (3, 7.5), (8, 7.5)])
def test_ddim_tok_kernel(cuda, n_cond, guidance):
    sd = t2m_denoiser(cuda)
    batch = 5
    g = torch.Generator().manual_seed(7)
    z0 = torch.randn(batch, 1, 256, generator=g).to(cuda)
    cond = torch.randn((2 if guidance > 1 else 1) * batch, n_cond, 768, generator=g).to(cuda)
    if guidance > 1:
        cond[:batch] = 0.0  # the uncond half, as T2MSystem.sample builds it
    sched = (DiffusionSchedule(), 10)
    before = dfu.ddim_fused_tok.launches
    z = dfu.ddim_fused_tok(sd, cond, z0, *sched, num_layers=5, guidance_scale=guidance)
    assert dfu.ddim_fused_tok.launches == before + 1
    ref = dfu.ddim_fused_plain(sd, cond, z0, *sched, num_layers=5, guidance_scale=guidance,
                               md_trans=False)
    assert rel_err(z, ref) < 1e-3


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
    assert dfu.ddim_fused_tok.launches == before


def test_kernel_wrappers_refuse_bad_input(cuda):
    w = pfu.pointnet_weights(seeded(ResnetPointnet(64, 512), 5, cuda))
    pts = torch.randn(2, 40, 3, device=cuda)
    args = [w[n] for n in ("wpos", "bpos", "w0", "b0", "w1", "b1", "ws")]
    with pytest.raises(ValueError, match="contiguous float32"):
        pfu.fused_input_block(pts.double(), *args)
    with pytest.raises(ValueError, match="contiguous float32"):
        pfu.fused_input_block(pts.transpose(0, 1).contiguous().transpose(0, 1), *args)
