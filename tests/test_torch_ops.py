"""Port parity of the modules that hold kernels: the plain versions of the
fused PointNet blocks (`ops/pointnet_fused.py`) and of the fused DDIM
samplers (`ops/denoiser_fused.py`: the MD stack behind `ddim_fused` and
`ddim_fused_grid`, the token-concat stack behind `ddim_fused_tok`) against
the JAX package on the CPU, f32 against f32. On a CPU tensor each wrapper runs its plain version and counts
no launch. The interpret-mode Pallas comparisons are marked slow, as
tests/test_pallas_ops.py marks its own.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import jax.scipy.special
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from seeme_tpu.diffusion.sampling import ddim_sample
from seeme_tpu.diffusion.schedulers import DiffusionSchedule as JSchedule
from seeme_tpu.models.denoiser import Denoiser as JDenoiser
from seeme_tpu.nn.pointnet import ResnetPointnet as JPointnet
from seeme_tpu.ops import denoiser_fused as j_df
from seeme_tpu.ops import pointnet_pallas as j_pp
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset
from seeme_tpu_torch.diffusion.schedulers import DiffusionSchedule
from seeme_tpu_torch.models.denoiser import Denoiser
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.nn.init import init_parameters_, perturb_parameters_
from seeme_tpu_torch.nn.pointnet import ResnetPointnet
from seeme_tpu_torch.ops import denoiser_fused as dfu
from seeme_tpu_torch.ops import pointnet_fused as pfu
from seeme_tpu_torch.ops import split_precision
from tools import convert_checkpoint as cc

NS, D = 5, 32  # DDIM steps and latent width of the small denoiser


def seeded(module, seed):
    init_parameters_(module, torch.Generator().manual_seed(seed))
    perturb_parameters_(module, torch.Generator().manual_seed(seed + 100))
    return module.requires_grad_(False).eval()


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def tree(x):
    return jax.tree.map(jnp.asarray, x)


@pytest.fixture(scope="module")
def pointnet_pair():
    net = seeded(ResnetPointnet(out_dim=24, hidden_dim=32), 1)
    params = tree(cc.convert_pointnet({k: v.numpy() for k, v in net.state_dict().items()}))
    return net, params, rand(2, 3, 64, 3)


def test_fused_input_block_plain(pointnet_pair):
    net, params, pts = pointnet_pair
    p = params["params"]
    b0 = p["block_0"]
    h = pts @ p["fc_pos_0"]["kernel"] + p["fc_pos_0"]["bias"]
    net_ = jax.nn.relu(h) @ b0["fc_0"]["kernel"] + b0["fc_0"]["bias"]
    ref = h @ b0["shortcut"]["kernel"] + jax.nn.relu(net_) @ b0["fc_1"]["kernel"] + b0["fc_1"]["bias"]
    w = pfu.pointnet_weights(net)
    out, pooled = pfu.fused_input_block_plain(
        torch.as_tensor(pts), *(w[n] for n in ("wpos", "bpos", "w0", "b0", "w1", "b1", "ws")))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref).max(axis=1), atol=1e-4)


def test_fused_split_block_plain(pointnet_pair):
    net, params, _ = pointnet_pair
    bp = params["params"]["block_2"]
    x = rand(3, 3, 64, 32)
    pooled = x.max(axis=1)
    hid = (jax.nn.relu(x) @ bp["fc_0_x"]["kernel"] + jax.nn.relu(pooled)[:, None] @ bp["fc_0_p"]["kernel"]
           + bp["fc_0_x"]["bias"])
    ref = (x @ bp["shortcut_x"]["kernel"] + pooled[:, None] @ bp["shortcut_p"]["kernel"]
           + jax.nn.relu(hid) @ bp["fc_1"]["kernel"] + bp["fc_1"]["bias"])
    w = pfu.pointnet_weights(net)
    out, out_max = pfu.fused_split_block_plain(
        torch.as_tensor(x), torch.as_tensor(pooled),
        *(w[f"block_2.{n}"] for n in ("w0x", "w0p", "b0", "w1", "b1", "wsx", "wsp")))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(out_max.numpy(), np.asarray(ref).max(axis=1), atol=1e-4)


def test_pointnet_forward_matches_xla_twin_and_flax(pointnet_pair):
    net, params, pts = pointnet_pair
    before = (pfu.fused_input_block.launches, pfu.fused_split_block.launches)
    ours = pfu.pointnet_forward(pfu.pointnet_weights(net), torch.as_tensor(pts)).numpy()
    assert (pfu.fused_input_block.launches, pfu.fused_split_block.launches) == before
    xla = jax.jit(j_pp._pointnet_forward_xla)(params, jnp.asarray(pts))
    np.testing.assert_allclose(ours, np.asarray(xla), atol=1e-4)
    flax_out = jax.jit(JPointnet(24, 32).apply)(params, jnp.asarray(pts))
    np.testing.assert_allclose(ours, np.asarray(flax_out), atol=1e-4)
    np.testing.assert_allclose(ours, net(torch.as_tensor(pts)).numpy(), atol=1e-5)


def test_wrappers_check_their_inputs(pointnet_pair):
    net, _, pts = pointnet_pair
    w = pfu.pointnet_weights(net)
    args = [w[n] for n in ("wpos", "bpos", "w0", "b0", "w1", "b1", "ws")]
    meta = torch.empty(3, 64, 3, device="meta")  # not CPU: the kernel path validates
    with pytest.raises(ValueError, match="hidden width"):
        pfu.fused_input_block(meta, *args)
    with pytest.raises(ValueError, match="hidden width"):
        pfu.fused_split_block(torch.empty(3, 64, 32, device="meta"), *([None] * 8))


def test_split_bf16_rebuilds_its_input():
    """hi + lo gives back t within 2^-16 relative, over six decades of
    magnitude; `split_weight` holds the (out, in) transpose's pair, hi rows
    over lo rows, K step by K step in the 32-byte swizzle."""
    t = torch.as_tensor(rand(11, 64, 96) * np.float32(10.0) ** np.clip(rand(12, 64, 96), -3, 3))
    hi, lo = pfu.split_bf16(t)
    assert hi.dtype == lo.dtype == torch.bfloat16 and hi.shape == lo.shape == t.shape
    assert bool(((hi.float() + lo.float() - t).abs() <= 2.0 ** -16 * t.abs()).all())
    w = torch.as_tensor(rand(13, 48, 32))  # (in, out)
    s = pfu.split_weight(w)
    assert s.shape == (3, 64, 16) and s.dtype == torch.bfloat16 and s.is_contiguous()
    stacked = torch.cat(pfu.split_bf16(w.t()))  # (64, 48): hi rows, then lo rows
    step, row, col = torch.meshgrid(torch.arange(3), torch.arange(64), torch.arange(16),
                                    indexing="ij")
    where = ((col // 8) ^ ((row >> 2) & 1)) * 8 + col % 8  # the swizzled column
    assert torch.equal(s[step, row, where], stacked[row, 16 * step + col])


def _three_products(a, w):
    """a w as the kernels compute it: hi hi + hi lo + lo hi of the bf16
    splits of both operands, summed in f32."""
    (a_hi, a_lo), (w_hi, w_lo) = (tuple(x.float() for x in pfu.split_bf16(t)) for t in (a, w))
    return a_hi @ w_hi + a_hi @ w_lo + a_lo @ w_hi


@pytest.mark.parametrize("block", ["input", "split"])
def test_three_split_products_hold_the_kernels_gate(block):
    """Each block with its products as three split-bf16 products stays within
    2e-5 of max|out| of its plain f32 version, the precision argument of
    `csrc/pointnet.cu` (the card's gate is 1e-4)."""
    net = seeded(ResnetPointnet(out_dim=24, hidden_dim=64), 11)
    w = pfu.pointnet_weights(net)
    pts = torch.as_tensor(rand(12, 2, 300, 3))
    x, pooled = pfu.fused_input_block_plain(
        pts, *(w[n] for n in ("wpos", "bpos", "w0", "b0", "w1", "b1", "ws")))
    if block == "input":
        ref = x
        h = pts @ w["wpos"] + w["bpos"]
        hidden = F.relu(_three_products(F.relu(h), w["w0"]) + w["b0"])
        got = _three_products(h, w["ws"]) + _three_products(hidden, w["w1"]) + w["b1"]
    else:
        b = {n: w[f"block_2.{n}"] for n in ("w0x", "w0p", "b0", "w1", "b1", "wsx", "wsp")}
        ref, _ = pfu.fused_split_block_plain(x, pooled, *b.values())
        c0 = (F.relu(pooled) @ b["w0p"] + b["b0"])[:, None]
        cs = (pooled @ b["wsp"] + b["b1"])[:, None]
        hidden = F.relu(_three_products(F.relu(x), b["w0x"]) + c0)
        got = _three_products(x, b["wsx"]) + _three_products(hidden, b["w1"]) + cs
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


@pytest.mark.parametrize("scheme", list(split_precision.SCHEMES))
def test_operand_schemes_against_the_gate(scheme):
    """PERF.md's precision table at a small width: the gate of 1e-4 of
    max|out| refuses every one-pass tensor-core scheme (TF32 rounded or
    truncated, bf16) on some block and passes both three-product schemes
    with a wide margin."""
    net = seeded(ResnetPointnet(out_dim=32, hidden_dim=32), 13)
    errors = split_precision.block_errors(net, torch.as_tensor(rand(14, 2, 200, 3)), scheme)
    if scheme in split_precision.SPLIT:
        assert max(errors) < 2e-5
    else:
        assert max(errors) > 1e-4


def test_pointnet_operands_split_afresh_after_an_update():
    """`SeeMeSystem._pointnet_operands` keeps its copies while the scene
    encoder is unchanged and makes the split bf16 pairs again after an
    in-place update of one of its weights."""
    data = SyntheticEgoDataset(2, 60, scene_points=64, seed=0)
    cfg = SeeMeConfig(latent_dim=(1, 32), ff_size=16, num_layers=3, scene_points=64,
                      scene_feat_dim=32)
    system = SeeMeSystem(cfg, synthetic_smpl(256), data.mean, data.std, device="cpu", seed=1)
    before = system._pointnet_operands()
    assert system._pointnet_operands() is before
    fc = system.proscene["scene_enc"].block_2.fc_1
    with torch.no_grad():
        fc.weight.add_(0.01)  # fc_1 starts at zero
    after = system._pointnet_operands()
    assert after is not before
    assert torch.equal(after["block_2.w1.split"], pfu.split_weight(fc.weight.t()))
    assert not torch.equal(after["block_2.w1.split"], before["block_2.w1.split"])
    assert torch.equal(after["w1.split"], before["w1.split"])  # block_0 untouched


@pytest.fixture(scope="module")
def denoiser_pair():
    den = seeded(Denoiser((1, D), ff_size=16, num_layers=3, text_encoded_dim=D), 4)
    sd = den.state_dict()
    params = tree(cc.convert_mld_checkpoint(
        {f"denoiser.{k}": v.numpy() for k, v in sd.items()})["denoiser"])
    jden = JDenoiser(nfeats=75, latent_dim=(1, D), ff_size=16, num_layers=3, dropout=0.0,
                     text_encoded_dim=D)
    return sd, params, jden


def test_md_step_invariants(denoiser_pair):
    sd, params, _ = denoiser_pair
    xf, tt = rand(5, 3, 2, D), rand(6, NS, D)
    ours = dfu.md_step_invariants(sd, torch.as_tensor(xf), 3, torch.as_tensor(tt))
    ref = jax.jit(lambda enc, a, b: j_df.md_step_invariants(enc, a, 3, time_tokens=b))(
        params["params"]["encoder"], jnp.asarray(xf), jnp.asarray(tt))
    names = {"encoder.input_blocks.0": "input_0", "encoder.middle_block": "middle",
             "encoder.output_blocks.0": "output_0"}
    assert list(ours) == list(names)
    for name, jname in names.items():
        for k, v in ours[name].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(ref[jname][k]), atol=1e-5,
                                       err_msg=f"{name}.{k}")


def test_denoiser_apply_pure_matches_flax(denoiser_pair):
    """Both sides use the exact erf GELU, so the plain twin agrees tightly
    (the JAX twin is held only to 5e-3 because it uses tanh)."""
    sd, params, jden = denoiser_pair
    x, cond, t = rand(7, 4, 1, D), rand(8, 4, 2, D), np.array([981, 601, 201, 1])
    ours = dfu.denoiser_apply_pure(sd, torch.as_tensor(x), torch.as_tensor(t),
                                   torch.as_tensor(cond), num_layers=3)
    ref = jax.jit(jden.apply)(params, *map(jnp.asarray, (x, t, cond)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def _exact_jax_ddim(params, jden, cond, z0, guidance):
    fn = lambda x, t, r: jden.apply(params, x, t, jnp.asarray(cond))  # noqa: E731
    return np.asarray(ddim_sample(fn, JSchedule(), jax.random.PRNGKey(0), z0.shape,
                                  num_inference_steps=NS, guidance_scale=guidance, z_init=z0))


@pytest.mark.parametrize("guidance", [1.0, 2.5])
def test_ddim_fused_plain_matches_exact_jax_path(denoiser_pair, guidance):
    """The flax `Denoiser` inside `ddim_sample(z_init=...)` is the reference;
    tolerance 1e-4 x max|z| (f32 both sides, 5 steps of the 1/sqrt(acp)
    recursion)."""
    sd, params, jden = denoiser_pair
    B = 3
    z0 = rand(9, B, 1, D)
    cond = rand(10, 2 * B if guidance > 1 else B, 2, D)
    if guidance > 1:
        cond[:B] = 0.0  # uncond half, as encode_conditioning builds it from zeroed inputs
    ref = _exact_jax_ddim(params, jden, cond, z0, guidance)
    sched = (DiffusionSchedule(), NS)
    before = dfu.ddim_fused.launches
    ours = dfu.ddim_fused(sd, torch.as_tensor(cond), torch.as_tensor(z0), *sched, num_layers=3,
                          guidance_scale=guidance).numpy()
    assert dfu.ddim_fused.launches == before  # CPU tensors: plain version, no launch
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(ours, ref, atol=1e-4 * scale)
    np.testing.assert_array_equal(
        ours, dfu.ddim_fused_plain(sd, torch.as_tensor(cond), torch.as_tensor(z0), *sched,
                                   num_layers=3, guidance_scale=guidance).numpy())


@pytest.mark.parametrize("width,splits", [(64, True), (128, True), (256, True), (1024, True),
                                          (32, False), (96, False), (100, False), (2048, False)])
def test_cluster_column_split(width, splits):
    """Both DDIM kernels split each product's output width over 8 CTAs in
    whole float4 quads whose count divides a warp, and its depth over 16
    warps in blocks of 4 rows (`splits` in csrc/ddim_common.cuh); the
    wrappers refuse any other width."""
    if splits:
        dfu._check_split("ddim", width)
    else:
        with pytest.raises(ValueError, match=f"width {width} does not split"):
            dfu._check_split("ddim", width)


def test_ddim_profile_instruments_both_kernels():
    """`ops/ddim_profile.py` finds every anchor it patches in the current DDIM
    sources (it raises when one is missing), so its counters stay in step
    with the kernels."""
    from seeme_tpu_torch.ops import ddim_profile

    src = ddim_profile.instrumented_sources()
    assert "g_prof" in src["ddim_common.cuh"]
    assert all(f"PROF_ADD({i}," in src["ddim_common.cuh"] for i in range(6))
    assert all("PROF_ADD(6, k1 - k0)" in src[k] for k in ("ddim_md.cuh", "ddim_tok.cuh"))


def test_kernel_weights_layout(denoiser_pair):
    """The pointer table's order is the enum of csrc/ddim_md.cuh: 32 operands
    per MD layer, (in, out) matrices, then skip_linears, final norm, pe row."""
    sd, _, _ = denoiser_pair
    kw = dfu.KernelWeights(sd, 3)
    assert len(kw.tensors) == 3 * 32 + 2 + 3 == kw.table.numel()
    assert kw.table.tolist() == [t.data_ptr() for t in kw.tensors]
    assert all(t.is_contiguous() for t in kw.tensors)
    w = sd["encoder.input_blocks.0.sa_block.self_attn.in_proj_weight"]
    torch.testing.assert_close(kw.tensors[0], w[:D].t(), rtol=0, atol=0)     # WQ
    torch.testing.assert_close(kw.tensors[4], w[2 * D:].t(), rtol=0, atol=0)  # WV
    mid = 32
    torch.testing.assert_close(kw.tensors[mid + 24], sd["encoder.middle_block.ffn.linear1.weight"].t())
    torch.testing.assert_close(kw.tensors[mid + 31],
                               sd["encoder.middle_block.ffn.proj_out.out_layers.2.bias"])
    torch.testing.assert_close(kw.tensors[96], sd["encoder.linear_blocks.0.weight"].t())
    torch.testing.assert_close(kw.tensors[-1], sd["query_pos.pe"][0, 0])
    assert (kw.d_model, kw.sa_ff, kw.ff) == (D, 1024, 16)


def _interpreted(module, fn, *args, **kw):
    orig = module.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(module.pl, "pallas_call", patched):
        return fn(*args, **kw)


@pytest.mark.slow
def test_pointnet_against_pallas_interpret(pointnet_pair):
    net, params, pts = pointnet_pair
    ref = _interpreted(j_pp, j_pp.pointnet_forward_pallas, params, jnp.asarray(pts))
    ours = pfu.pointnet_forward(pfu.pointnet_weights(net), torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), atol=2e-4)


@pytest.mark.slow
@pytest.mark.parametrize("guidance", [1.0, 2.5])
def test_ddim_against_pallas_interpret(denoiser_pair, guidance):
    """The Pallas kernel keeps bf16 weights and uses tanh GELU: bound
    0.02 x max|z|, as tests/test_pallas_ops.py holds it."""
    sd, params, _ = denoiser_pair
    B = 3
    z0, cond = rand(11, B, 1, D), rand(12, 2 * B if guidance > 1 else B, 2, D)
    jarr = j_df.ddim_schedule_arrays(JSchedule(), NS)
    ref = np.asarray(j_df.ddim_fused(params, jnp.asarray(cond), jnp.asarray(z0), *jarr,
                                     num_steps=NS, num_layers=3, guidance_scale=guidance,
                                     interpret=True))
    ours = dfu.ddim_fused(sd, torch.as_tensor(cond), torch.as_tensor(z0),
                          DiffusionSchedule(), NS, num_layers=3,
                          guidance_scale=guidance).numpy()
    np.testing.assert_allclose(ours, ref, atol=0.02 * float(np.abs(ref).max()))


@pytest.mark.parametrize("guidance", [1.0, 2.5])
def test_ddim_fused_grid_matches_exact_jax_path(denoiser_pair, guidance):
    """The grid entry runs the same plain version on CPU tensors, counting no
    launch, and meets the exact JAX path as `ddim_fused` does."""
    sd, params, jden = denoiser_pair
    B = 3
    z0 = rand(20, B, 1, D)
    cond = rand(21, 2 * B if guidance > 1 else B, 2, D)
    if guidance > 1:
        cond[:B] = 0.0
    ref = _exact_jax_ddim(params, jden, cond, z0, guidance)
    before = dfu.ddim_fused_grid.launches
    ours = dfu.ddim_fused_grid(sd, torch.as_tensor(cond), torch.as_tensor(z0), DiffusionSchedule(),
                               NS, num_layers=3, guidance_scale=guidance).numpy()
    assert dfu.ddim_fused_grid.launches == before
    np.testing.assert_allclose(ours, ref, atol=1e-4 * float(np.abs(ref).max()))


TEXT = 48  # text width of the small token-path denoiser (emb_proj 48 -> 32)


@pytest.fixture(scope="module")
def token_pair():
    den = seeded(Denoiser((1, D), ff_size=16, num_layers=3, text_encoded_dim=TEXT,
                          md_trans=False), 14)
    sd = den.state_dict()
    params = tree(cc.convert_mld_checkpoint(
        {f"denoiser.{k}": v.numpy() for k, v in sd.items()})["denoiser"])
    jden = JDenoiser(nfeats=263, latent_dim=(1, D), ff_size=16, num_layers=3, dropout=0.0,
                     text_encoded_dim=TEXT, md_trans=False)
    return sd, params, jden


def _exact_gelu(x, approximate=False):
    return 0.5 * x * (1.0 + jax.scipy.special.erf(x / np.sqrt(2.0)).astype(x.dtype))


def test_denoiser_apply_pure_token_path(token_pair):
    """The token-concat twin against the JAX twin (`denoiser_fused.py:416-432`),
    whose tanh GELU (a Mosaic workaround) is set to the exact erf form here,
    and against the flax module, both within 1e-4. The precomputed
    time_token path gives the same result."""
    sd, params, jden = token_pair
    x, cond, t = rand(22, 4, 1, D), rand(23, 4, 3, TEXT), np.array([981, 601, 201, 1])
    ours = dfu.denoiser_apply_pure(sd, torch.as_tensor(x), torch.as_tensor(t),
                                   torch.as_tensor(cond), num_layers=3, md_trans=False)
    with mock.patch.object(jax.nn, "gelu", _exact_gelu):
        ref = j_df.denoiser_apply_pure(params, *map(jnp.asarray, (x, t, cond)), 3,
                                       md_trans=False)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    flax_out = jax.jit(jden.apply)(params, *map(jnp.asarray, (x, t, cond)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(flax_out), atol=1e-4)
    token = dfu._time_tokens(sd, torch.as_tensor(t))[:, None]
    again = dfu.denoiser_apply_pure(sd, torch.as_tensor(x), None, torch.as_tensor(cond),
                                    num_layers=3, md_trans=False, time_token=token)
    torch.testing.assert_close(again, ours, rtol=0, atol=0)


@pytest.mark.parametrize("guidance", [1.0, 7.5])
def test_ddim_fused_tok_matches_exact_jax_path(token_pair, guidance):
    """The flax token-concat `Denoiser` inside `ddim_sample(z_init=...)` is
    the reference; tolerance 1e-4 x max|z|. The uncond half is a zero
    embedding, which relu -> emb_proj turns into the projection's bias."""
    sd, params, jden = token_pair
    B = 3
    z0 = rand(24, B, 1, D)
    text = rand(25, B, 1, TEXT)
    cond = np.concatenate([np.zeros_like(text), text]) if guidance > 1 else text
    ref = _exact_jax_ddim(params, jden, cond, z0, guidance)
    before = dfu.ddim_fused_tok.launches
    ours = dfu.ddim_fused_tok(sd, torch.as_tensor(cond), torch.as_tensor(z0), DiffusionSchedule(),
                              NS, num_layers=3, guidance_scale=guidance).numpy()
    assert dfu.ddim_fused_tok.launches == before  # CPU tensors: plain version, no launch
    np.testing.assert_allclose(ours, ref, atol=1e-4 * float(np.abs(ref).max()))
    np.testing.assert_array_equal(
        ours, dfu.ddim_fused_plain(sd, torch.as_tensor(cond), torch.as_tensor(z0),
                                   DiffusionSchedule(), NS, num_layers=3,
                                   guidance_scale=guidance, md_trans=False).numpy())


def test_token_kernel_weights_layout(token_pair):
    """The pointer table's order is the enum of csrc/ddim_tok.cuh: 16 operands
    per encoder layer, (in, out) matrices, then skip_linears, final norm, pe row."""
    sd, _, _ = token_pair
    kw = dfu.KernelWeights(sd, 3, md_trans=False)
    assert len(kw.tensors) == 3 * 16 + 2 + 3 == kw.table.numel()
    assert kw.table.tolist() == [t.data_ptr() for t in kw.tensors]
    w = sd["encoder.input_blocks.0.self_attn.in_proj_weight"]
    torch.testing.assert_close(kw.tensors[2], w[D:2 * D].t(), rtol=0, atol=0)  # WK
    torch.testing.assert_close(kw.tensors[16 + 12], sd["encoder.middle_block.linear2.weight"].t())
    torch.testing.assert_close(kw.tensors[48], sd["encoder.linear_blocks.0.weight"].t())
    torch.testing.assert_close(kw.tensors[-1], sd["query_pos.pe"][0, 0])
    assert (kw.d_model, kw.ff, kw.md_trans) == (D, 16, False)


def test_token_wrapper_checks_its_inputs(token_pair):
    """Off the CPU the wrapper validates before it builds or launches
    anything (meta tensors stand in for the card's)."""
    sd, _, _ = token_pair
    meta = {k: v.to("meta") for k, v in sd.items()}
    z0 = torch.empty(2, 1, D, device="meta")
    sched = (DiffusionSchedule(), NS)
    before = dfu.ddim_fused_tok.launches
    with pytest.raises(ValueError, match="latent width"):
        dfu.ddim_fused_tok(meta, torch.empty(2, 1, TEXT, device="meta"), z0, *sched,
                           num_layers=3)
    with pytest.raises(ValueError, match="for batch 2"):
        dfu.ddim_fused_tok(meta, torch.empty(2, 1, TEXT, device="meta"), z0, *sched,
                           num_layers=3, guidance_scale=7.5)
    with pytest.raises(ValueError, match="9 condition tokens; the kernel takes 1 to 8"):
        dfu.ddim_fused_tok(meta, torch.empty(2, 9, TEXT, device="meta"),
                           torch.empty(2, 2, D, device="meta"), *sched, num_layers=3)
    assert dfu.ddim_fused_tok.launches == before


@pytest.mark.slow
@pytest.mark.parametrize("guidance", [1.0, 7.5])
def test_ddim_tok_against_pallas_interpret(token_pair, guidance):
    """The Pallas `ddim_fused(md_trans=False)` keeps bf16 weights and uses
    tanh GELU: bound 0.02 x max|z|, as tests/test_pallas_ops.py holds it."""
    sd, params, _ = token_pair
    B = 3
    z0, text = rand(26, B, 1, D), rand(27, B, 1, TEXT)
    cond = np.concatenate([np.zeros_like(text), text]) if guidance > 1 else text
    jarr = j_df.ddim_schedule_arrays(JSchedule(), NS)
    ref = np.asarray(j_df.ddim_fused(params, jnp.asarray(cond), jnp.asarray(z0), *jarr,
                                     num_steps=NS, num_layers=3, guidance_scale=guidance,
                                     md_trans=False, interpret=True))
    ours = dfu.ddim_fused_tok(sd, torch.as_tensor(cond), torch.as_tensor(z0),
                              DiffusionSchedule(), NS, num_layers=3,
                              guidance_scale=guidance).numpy()
    np.testing.assert_allclose(ours, ref, atol=0.02 * float(np.abs(ref).max()))


@pytest.mark.slow
def test_ddim_grid_against_pallas_interpret(denoiser_pair):
    """The Pallas `ddim_fused_grid`, bf16 weights and tanh GELU: 0.02 x max|z|."""
    sd, params, _ = denoiser_pair
    B = 3
    z0, cond = rand(28, B, 1, D), rand(29, 2 * B, 2, D)
    jarr = j_df.ddim_schedule_arrays(JSchedule(), NS)
    ref = np.asarray(j_df.ddim_fused_grid(params, jnp.asarray(cond), jnp.asarray(z0), *jarr,
                                          num_steps=NS, num_layers=3, guidance_scale=2.5,
                                          interpret=True))
    ours = dfu.ddim_fused_grid(sd, torch.as_tensor(cond), torch.as_tensor(z0),
                               DiffusionSchedule(), NS, num_layers=3,
                               guidance_scale=2.5).numpy()
    np.testing.assert_allclose(ours, ref, atol=0.02 * float(np.abs(ref).max()))
