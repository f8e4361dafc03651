"""The frozen operation counts against FlopCounterMode over the plain
reference at small shapes, and the frozen byte counts against the sizes of
the kernels' own operands."""

import pytest
import torch

from portbench import counts
from portbench.reference import plain
from seeme_tpu_torch.models.denoiser import Denoiser
from seeme_tpu_torch.nn.pointnet import ResnetPointnet
from seeme_tpu_torch.ops import pointnet_fused


def state(module, prefix):
    g = torch.Generator().manual_seed(0)
    return {f"{prefix}.{k}": torch.randn(v.shape, generator=g) * 0.1
            for k, v in module.state_dict().items()}


@pytest.mark.parametrize("B,N,H,out", [(2, 10, 16, 8), (3, 7, 32, 16)])
def test_pointnet_counts(B, N, H, out):
    sd = state(ResnetPointnet(out_dim=out, hidden_dim=H), "enc")
    ref = plain.Ref(sd, plain.Arith())
    pts = torch.randn(B, N, 3)
    n = counts.counted_flops(lambda: plain.pointnet(ref, "enc", pts))
    assert n == (counts.input_block_flops(B, N, H) + 3 * counts.split_block_flops(B, N, H)
                 + 2 * B * H * out)


@pytest.mark.parametrize("B,N,H", [(2, 10, 32), (1, 64, 16)])
def test_pointnet_bytes(B, N, H):
    enc = ResnetPointnet(out_dim=H, hidden_dim=H)
    w = pointnet_fused.pointnet_weights(enc)
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    split_in = [w[f"{k}.split"] for k in pointnet_fused.INPUT_SPLIT]
    split_blk = [w[f"block_1.{k}.split"] for k in pointnet_fused.BLOCK_SPLIT]
    x, pooled, out = torch.empty(B, N, H), torch.empty(B, H), 4 * (B * N * H + B * H)
    assert counts.input_block_bytes(B, N, H) == nbytes(
        torch.empty(B, N, 3), w["wpos"], w["bpos"], w["b0"], w["b1"], *split_in) + out
    assert counts.split_block_bytes(B, N, H) == nbytes(
        x, pooled, w["block_1.w0p"], w["block_1.b0"], w["block_1.b1"], w["block_1.wsp"],
        *split_blk) + out


def denoiser_state(md_trans, D=32, ff=16, layers=3, text=32):
    d = Denoiser((1, D), ff, layers, 1, text_encoded_dim=text, md_trans=md_trans)
    return state(d, "denoiser")


@pytest.mark.parametrize("guidance", [1.0, 2.5])
@pytest.mark.parametrize("B,NC,steps", [(2, 2, 4), (3, 1, 2)])
def test_ddim_md_count(B, NC, steps, guidance):
    sd, L, D = denoiser_state(True), 3, 32
    ref = plain.Ref(sd, plain.Arith())
    rows = B * (2 if guidance > 1 else 1)
    cond, z = torch.randn(rows, NC, D), torch.randn(B, 1, D)
    sched = plain.Schedule(1000, 0.00085, 0.012, "scaled_linear", False, 1)

    def run():
        win = ref.md_window(ref.project_cond(cond), L)
        return plain.ddim(sched, steps, z, lambda x, t: ref.md_denoise(
            x, win, ref.time_token(t, 32, x.device), L), guidance)

    assert counts.counted_flops(run) == counts.ddim_md_flops(
        counts.denoiser_shapes(sd), L, rows, NC, steps)


def test_ddim_bytes():
    sd = denoiser_state(True)
    numels = counts.denoiser_numels(sd)
    want = 4 * (sum(numels.values()) + 2 * 2 * 32 + 2 * 2 * 32 + 2 * 50)
    assert counts.ddim_bytes(numels, 2, 2, 2, 1, 32, 50) == want


def test_bound():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
