"""The GCN kernels' operands (`seeme_tpu_torch/ops/gcn_fused.py`) on the CPU:
the packed split weights and the tiled activations give back their f32
values within the split-TF32 scheme's unit, in TF32's 10-bit mantissas; the adjacency halves are
`ModulatedGraphConv.forward`'s bitwise; the coefficient table is
`ddpm_step`'s bitwise at every respaced step (and gives x_0 = pred at t =
0); the input conv's hoisted parts (vis_j P_img + P_rest + the pose part +
the timestep row) give the eager input conv on both branches; and the
kernels' arithmetic, written out in f32 over those operands, follows the
plain sampling at the test CLI's tiny widths. The kernels themselves run in
`tests/test_torch_gpu.py`."""

import pytest
import torch

from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.models.egohmr import EgoHmr, EgoHmrConfig
from seeme_tpu_torch.ops import gcn_fused as gf
from seeme_tpu_torch.ops import split_precision

TINY = dict(gcn_hid_dim=128, gcn_layers=1, num_train_timesteps=100,
            timestep_respacing="ddim10")   # test_egohmr.py --tiny
B = 3
UNIT = 2.0 ** -21   # TF32 hi + lo leaves at most this of |value| out


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_model(only_mask_img_cond=True, **kw):
    model = EgoHmr(EgoHmrConfig(**TINY, only_mask_img_cond=only_mask_img_cond, **kw),
                   synthetic_smpl(n_verts=64), device="cpu", seed=3)
    split_precision.draw_like_the_cell_(model, 4)
    return model


def inputs(model, seed=0):
    """Encoded features, visibility (some joints hidden) and a state."""
    g = torch.Generator().manual_seed(seed)
    cfg = model.cfg
    enc = {"img": torch.randn(B, cfg.img_feat_dim, generator=g).abs(),
           "rest": torch.randn(B, cfg.context_dim - cfg.img_feat_dim, generator=g)}
    vis = torch.rand(B, 24, generator=g) > 0.3
    return enc, vis, torch.randn(B, 144, generator=g)


def unswizzle(t: torch.Tensor) -> torch.Tensor:
    """Slot images (..., rows, 8) back to plain K steps: the two 16-byte
    halves of rows with bit 2 set swapped back."""
    rows = t.shape[-2]
    swap = ((torch.arange(rows) >> 2) & 1).bool()[:, None, None]
    h = t.reshape(*t.shape[:-1], 2, gf.KS // 2)
    return torch.where(swap, h.flip(-2), h).reshape(t.shape)


@pytest.mark.parametrize("n_in,n_out", [(128, 128), (1024, 1024), (512, 192)])
def test_packed_split_weights_give_back_w(n_in, n_out):
    W = torch.randn(2, n_in, n_out, generator=torch.Generator().manual_seed(n_in + n_out))
    packed = gf.pack_weight(W)
    C = gf.CHANNELS
    assert packed.dtype == torch.float32 and tuple(packed.shape) == (n_out // C, n_in // 8,
                                                                     4 * C, 8)
    plain = unswizzle(packed).permute(0, 2, 1, 3).reshape(n_out // C, 4 * C, n_in)
    got = (plain[:, :2 * C] + plain[:, 2 * C:]).transpose(1, 2)       # (tiles, in, h0 | h1)
    want = torch.stack([torch.cat([W[0, :, c:c + C], W[1, :, c:c + C]], dim=1)
                        for c in range(0, n_out, C)])
    assert torch.all((got - want).abs() <= UNIT * want.abs())
    assert not torch.equal(plain[:, :2 * C], want.transpose(1, 2))   # the hi half alone is not W
    assert torch.all(packed.view(torch.int32) & 0x1FFF == 0)        # TF32: 13 low bits clear


def test_tiled_rows_give_back_the_rows():
    x = torch.randn(2 * gf.TILE_ROWS, 128, generator=torch.Generator().manual_seed(1))
    t = gf.tile_rows(x)
    assert tuple(t.shape) == (2, 128 // 8, 2 * gf.TILE_ROWS, 8)
    plain = unswizzle(t)                                              # (tiles, ks, 2 x 192, 8)
    got = (plain[:, :, :gf.TILE_ROWS] + plain[:, :, gf.TILE_ROWS:]).permute(0, 2, 1, 3)
    got = got.reshape(x.shape)
    assert torch.all((got - x).abs() <= UNIT * x.abs())


def test_adjacency_halves_are_the_modules_bitwise():
    model = tiny_model()
    convs = [model.diffusion_model.gconv_input[0].gconv, model.diffusion_model.gconv_output,
             *(b.gconv for layer in model.diffusion_model.gconv_layers
               for b in (layer.gconv1, layer.gconv2))]
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 24, 128, generator=g)
    w = gf.gcn_weights(model)
    for conv in convs:
        diag, off = gf.adjacency_halves(conv)
        xin = x if conv.W.shape[1] == 128 else torch.randn(2, 24, conv.W.shape[1], generator=g)
        h0, h1 = xin @ conv.W[0], xin @ conv.W[1]
        want = conv(xin)
        got = torch.diag(diag) @ (conv.M * h0) + off @ (conv.M * h1) + conv.bias
        assert torch.equal(got, want)
        assert torch.all(torch.diagonal(off) == 0) and not torch.equal(off, off.T * 0)
    assert torch.equal(w["conv0.adj"], torch.cat([gf.adjacency_halves(convs[0])[1].reshape(-1),
                                                  gf.adjacency_halves(convs[0])[0]]))


def test_coefficient_table_is_ddpm_steps_bitwise():
    model = tiny_model()
    sched = model.sample_schedule
    table = gf.ddpm_table(sched)
    S = sched.num_train_timesteps
    assert table.dtype == torch.float32 and tuple(table.shape) == (S, 3)
    one, zero = torch.ones(4), torch.zeros(4)
    for t in range(S):
        assert torch.equal(sched.ddpm_step(one, t, zero, zero), table[t, 0].expand(4))
        assert torch.equal(sched.ddpm_step(zero, t, one, zero), table[t, 1].expand(4))
        if t > 0:
            assert torch.equal(sched.ddpm_step(zero, t, zero, one), table[t, 2].expand(4))
    assert table[0, 0] == 1.0 and table[0, 1] == 0.0     # x_0 = pred at t = 0
    pred, x = torch.randn(4), torch.randn(4)
    assert torch.equal(table[0, 0] * pred + table[0, 1] * x, pred)


@pytest.mark.parametrize("only_mask_img_cond", [True, False])
def test_hoisted_input_conv_is_the_eager_one(only_mask_img_cond):
    model = tiny_model(only_mask_img_cond)
    enc, vis, x = inputs(model)
    w = gf.gcn_weights(model)
    rb = gf.ReverseBatch(model, w, enc, vis)
    conv = model.diffusion_model.gconv_input[0].gconv
    cond = model.conditioning(enc, vis)
    cond2 = torch.cat([cond, model.mask_cond(cond)])
    emb = model.input_process.poseEmbedding(x.reshape(B, 24, 6))
    S = model.sample_schedule.num_train_timesteps
    for row, ts in [(t, int(model.timestep_map[t])) for t in range(S)] + [(S, 0)]:
        t_emb = model.embed_timestep(torch.full((2 * B,), ts))[:, None].expand(-1, 24, -1)
        inp = torch.cat([cond2, torch.cat([emb, emb]), t_emb], dim=-1)
        want = torch.stack([inp @ conv.W[0], inp @ conv.W[1]], dim=2)     # (2B, 24, 2, H)
        got = (rb.p_rest[:, None] + w["in.time"][row]
               + torch.einsum("sjd,dkc->sjkc", torch.cat([x, x]).reshape(2 * B, 24, 6),
                              w["in.wx"]))
        got[:B] += rb.vis[:B, :, None, None] * rb.p_img[:, None]
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def emulate(rb, x, t=None, eps=None):
    """The kernels' arithmetic in f32 over `rb`'s operands (the products
    unsplit): input conv, hidden convs, output kernel."""
    w, model = rb.weights, rb.model
    S = w["coef"].shape[0]

    def mix(h0, h1, adj, m):
        off, diag = adj[:576].reshape(24, 24), adj[576:]
        return diag[:, None] * (m * h0) + off @ (m * h1)

    def epilogue(h0, h1, i):
        out = mix(h0, h1, w[f"conv{i}.adj"], w[f"conv{i}.m"])
        return torch.relu(w[f"conv{i}.scale"] * out + w[f"conv{i}.shift"])

    pre = (rb.p_rest[:, None] + w["in.time"][S if t is None else t]
           + torch.einsum("sjd,dkc->sjkc", torch.cat([x, x]).reshape(2 * rb.B, 24, 6), w["in.wx"]))
    pre[:rb.B] += rb.vis[:, :, None, None] * rb.p_img[:, None]
    h = epilogue(pre[:, :, 0], pre[:, :, 1], 0)
    for i, layer in enumerate(model.diffusion_model.gconv_layers):
        a = h
        for k, block in ((2 * i + 1, layer.gconv1), (2 * i + 2, layer.gconv2)):
            a = epilogue(a @ block.gconv.W[0], a @ block.gconv.W[1], k)
        h = h + a
    ow = w["out.w"]
    pred = (mix(h @ ow[:, :6], h @ ow[:, 6:], w["out.adj"], w["out.m"]) + w["out.bias"])
    pred, pred_uncond = pred.reshape(2 * rb.B, 144).chunk(2)
    p = torch.where(rb.vis.bool().repeat_interleave(6, dim=-1), pred, pred_uncond)
    if t is None:
        return p
    c = w["coef"][t]
    y = c[0] * p + c[1] * x
    return y + c[2] * eps if eps is not None else y


@pytest.mark.parametrize("only_mask_img_cond", [True, False])
def test_kernel_arithmetic_follows_the_plain_sampling(only_mask_img_cond):
    """The whole tiny sampling, 10 steps and the final prediction, both ways
    from the same state and noise: within 1e-4 of max |pose|."""
    model = tiny_model(only_mask_img_cond)
    enc, vis, x0 = inputs(model, seed=1)
    w = gf.gcn_weights(model)
    plain, kern = gf.ReverseBatch(model, None, enc, vis), gf.ReverseBatch(model, w, enc, vis)
    S = model.sample_schedule.num_train_timesteps
    g = torch.Generator().manual_seed(2)
    xp = xk = x0
    with torch.no_grad():
        for t in range(S - 1, -1, -1):
            eps = torch.randn(B, 144, generator=g) if t > 0 else None
            xp, xk = gf.gcn_fused(plain, xp, t, eps), emulate(kern, xk, t, eps)
        want, got = gf.gcn_fused(plain, xp), emulate(kern, xk)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert float(want.abs().max()) > 1e-2


def test_cpu_step_is_the_plain_one_and_launches_nothing():
    model = tiny_model()
    enc, vis, x = inputs(model, seed=2)
    before = gf.gcn_fused.launches
    rb = model._fused_gcn.batch(model, enc, vis)
    assert rb.weights is None
    eps = torch.randn(B, 144)
    with torch.no_grad():
        assert torch.equal(gf.gcn_fused(rb, x, 5, eps), gf.gcn_fused_plain(rb, x, 5, eps))
    assert gf.gcn_fused.launches == before


def test_weights_are_made_again_after_a_load():
    model = tiny_model()
    fused = gf.FusedGcn()
    first = fused.weights(model)
    assert fused.weights(model) is first
    sd = {k: v + 0.01 for k, v in model.diffusion_model.state_dict().items()}
    model.diffusion_model.load_state_dict(sd)
    again = fused.weights(model)
    assert again is not first and not torch.equal(again["conv1.w"], first["conv1.w"])
