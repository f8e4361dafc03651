"""Port parity of the network modules: transformer layers and U-skip stacks,
MD stylization layer, PointNet, motion VAE and denoiser of `seeme_tpu_torch`
against the flax modules of `seeme_tpu`, on the CPU in f32.

Port weights are the seeded init plus a seeded perturbation (so the
zero-initialized branches carry signal); they cross to flax through
`tools/convert_checkpoint.py`, the reference's own torch -> JAX converter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.models.denoiser import Denoiser as JDenoiser
from seeme_tpu.models.vae import MotionVae as JVae
from seeme_tpu.nn import pointnet as j_pointnet
from seeme_tpu.nn import stylization as j_sty
from seeme_tpu.nn import transformer as j_tr
from seeme_tpu_torch.models.denoiser import Denoiser
from seeme_tpu_torch.models.vae import MotionVae
from seeme_tpu_torch.nn import pointnet, stylization, transformer
from seeme_tpu_torch.nn.init import init_parameters_, perturb_parameters_
from tools import convert_checkpoint as cc

ATOL = 1e-4  # f32 against f32; differences are summation order only


def seeded(module, seed=0):
    init_parameters_(module, torch.Generator().manual_seed(seed))
    perturb_parameters_(module, torch.Generator().manual_seed(seed + 100))
    return module.eval()


def sd_np(module, prefix=""):
    return {f"{prefix}{k}": v.detach().numpy() for k, v in module.state_dict().items()}


def tree(x):
    return jax.tree.map(jnp.asarray, x)


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)


def valid_mask(B, n):
    """All keys valid except the last two of sample 0."""
    m = np.ones((B, n), bool)
    m[0, n - 2:] = False
    return m


def test_encoder_layer_with_mask():
    layer = seeded(transformer.TransformerEncoderLayer(32, 2, 48, "gelu"))
    x, m = rand(1, 3, 6, 32), valid_mask(3, 6)
    ref = jax.jit(j_tr.TransformerEncoderLayer(32, 2, 48, 0.0, "gelu").apply)(
        {"params": tree(cc.convert_encoder_layer(sd_np(layer, "l."), "l"))},
        jnp.asarray(x), jnp.asarray(m))
    close(layer(torch.as_tensor(x), torch.as_tensor(m)), ref)


def test_decoder_layer_with_masks():
    layer = seeded(transformer.TransformerDecoderLayer(32, 1, 40, "gelu"), 2)
    tgt, mem, m = rand(2, 2, 5, 32), rand(3, 2, 3, 32), valid_mask(2, 5)
    ref = jax.jit(j_tr.TransformerDecoderLayer(32, 1, 40, 0.0, "gelu").apply)(
        {"params": tree(cc.convert_decoder_layer(sd_np(layer, "l."), "l"))},
        jnp.asarray(tgt), jnp.asarray(mem), jnp.asarray(m))
    close(layer(torch.as_tensor(tgt), torch.as_tensor(mem), torch.as_tensor(m)), ref)


def test_skip_transformer_encoder():
    stack = seeded(transformer.SkipTransformerEncoder(
        lambda: transformer.TransformerEncoderLayer(32, 1, 16, "gelu"), 3, 32), 3)
    x, m = rand(4, 2, 5, 32), valid_mask(2, 5)
    make = lambda name: j_tr.TransformerEncoderLayer(32, 1, 16, 0.0, "gelu", name=name)  # noqa: E731
    ref = jax.jit(j_tr.SkipTransformerEncoder(make, 3, 32).apply)(
        {"params": tree(cc.convert_skip_transformer(sd_np(stack, "s."), "s", 3))},
        jnp.asarray(x), key_valid_mask=jnp.asarray(m))
    close(stack(torch.as_tensor(x), key_valid_mask=torch.as_tensor(m)), ref)


def test_md_transformer_layer():
    layer = seeded(stylization.MdTransformerLayer(32, 1, ffn_dim=16), 4)
    x, xf, emb = rand(5, 3, 1, 32), rand(6, 3, 2, 32), rand(7, 3, 1, 32)
    ref = jax.jit(j_sty.MdTransformerLayer(32, 1, ffn_dim=16, dropout=0.0).apply)(
        {"params": tree(cc.convert_md_layer(sd_np(layer, "l."), "l"))},
        jnp.asarray(x), jnp.asarray(xf), jnp.asarray(emb))
    close(layer(*map(torch.as_tensor, (x, xf, emb))), ref)


def test_resnet_pointnet():
    net = seeded(pointnet.ResnetPointnet(out_dim=24, hidden_dim=32), 5)
    pts = rand(8, 2, 64, 3)
    ref = jax.jit(j_pointnet.ResnetPointnet(out_dim=24, hidden_dim=32).apply)(
        tree(cc.convert_pointnet(sd_np(net))), jnp.asarray(pts))
    close(net(torch.as_tensor(pts)), ref)


def _vae_pair():
    vae = seeded(MotionVae(75, (1, 32), ff_size=16, num_layers=3), 6)
    params = tree(cc.convert_mld_checkpoint(sd_np(vae, "vae."))["vae"])
    return vae, JVae(75, (1, 32), ff_size=16, num_layers=3, dropout=0.0), params


def test_vae_encode_with_lengths():
    vae, jvae, params = _vae_pair()
    feats, lengths = rand(9, 3, 20, 75), np.array([20, 13, 7])
    mu, logvar = vae.encode(torch.as_tensor(feats), torch.as_tensor(lengths))
    mu_r, logvar_r = jax.jit(lambda p, f, n: jvae.apply(p, f, n, method=jvae.encode))(
        params, jnp.asarray(feats), jnp.asarray(lengths))
    assert mu.shape == (3, 1, 32)
    close(mu, mu_r)
    close(logvar, logvar_r)


def test_vae_decode():
    vae, jvae, params = _vae_pair()
    z = rand(10, 3, 1, 32)
    out = vae.decode(torch.as_tensor(z), 20)
    assert out.shape == (3, 20, 75)
    close(out, jax.jit(lambda p, z: jvae.apply(p, z, 20, method=jvae.decode))(params, jnp.asarray(z)))


@pytest.mark.parametrize("n_tok", [1, 2])
def test_denoiser(n_tok):
    den = seeded(Denoiser((n_tok, 32), ff_size=16, num_layers=3, text_encoded_dim=32), 7)
    params = tree(cc.convert_mld_checkpoint(sd_np(den, "denoiser."))["denoiser"])
    x, cond, t = rand(11, 3, n_tok, 32), rand(12, 3, 2, 32), np.array([981, 501, 21])
    ref = JDenoiser(nfeats=75, latent_dim=(n_tok, 32), ff_size=16, num_layers=3, dropout=0.0,
                    text_encoded_dim=32)
    ref = jax.jit(ref.apply)(params, *map(jnp.asarray, (x, t, cond)))
    close(den(*map(torch.as_tensor, (x, t, cond))), ref)


def test_denoiser_condition_projection():
    """text_encoded_dim != d_model adds the relu -> Linear `emb_proj`."""
    den = seeded(Denoiser((1, 32), ff_size=16, num_layers=3, text_encoded_dim=24), 8)
    params = tree(cc.convert_mld_checkpoint(sd_np(den, "denoiser."))["denoiser"])
    x, cond, t = rand(13, 2, 1, 32), rand(14, 2, 3, 24), np.array([961, 41])
    ref = JDenoiser(nfeats=75, latent_dim=(1, 32), ff_size=16, num_layers=3, dropout=0.0,
                    text_encoded_dim=24)
    ref = jax.jit(ref.apply)(params, *map(jnp.asarray, (x, t, cond)))
    close(den(*map(torch.as_tensor, (x, t, cond))), ref)


def test_vae_decode_with_lengths():
    """Frames past each length are masked as keys of the decoder's
    self-attention (`seeme_tpu/models/vae.py:135-165`)."""
    vae, jvae, params = _vae_pair()
    z, lengths = rand(15, 3, 1, 32), np.array([20, 11, 4])
    out = vae.decode(torch.as_tensor(z), 20, torch.as_tensor(lengths))
    ref = jax.jit(lambda p, z, n: jvae.apply(p, z, 20, n, method=jvae.decode))(
        params, jnp.asarray(z), jnp.asarray(lengths))
    close(out, ref)
    assert not np.allclose(out.detach().numpy(), vae.decode(torch.as_tensor(z), 20).detach().numpy(),
                           atol=1e-3)


@pytest.mark.parametrize("text_dim", [32, 48], ids=["no_emb_proj", "emb_proj"])
def test_token_denoiser(text_dim):
    """md_trans=False: plain GELU encoder layers over [sample; time; cond],
    the first n_latent outputs kept (`seeme_tpu/models/denoiser.py:180-188`)."""
    den = seeded(Denoiser((1, 32), ff_size=16, num_layers=3, text_encoded_dim=text_dim,
                          md_trans=False), 9)
    assert hasattr(den, "emb_proj") == (text_dim != 32)
    params = tree(cc.convert_mld_checkpoint(sd_np(den, "denoiser."))["denoiser"])
    x, cond, t = rand(16, 3, 1, 32), rand(17, 3, 2, text_dim), np.array([981, 501, 21])
    ref = JDenoiser(nfeats=263, latent_dim=(1, 32), ff_size=16, num_layers=3, dropout=0.0,
                    text_encoded_dim=text_dim, md_trans=False)
    ref = jax.jit(ref.apply)(params, *map(jnp.asarray, (x, t, cond)))
    close(den(*map(torch.as_tensor, (x, t, cond))), ref)


def test_token_denoiser_cond_mask():
    """cond_mask excludes padded condition tokens as attention keys."""
    den = seeded(Denoiser((1, 32), ff_size=16, num_layers=3, text_encoded_dim=48,
                          md_trans=False), 10)
    params = tree(cc.convert_mld_checkpoint(sd_np(den, "denoiser."))["denoiser"])
    x, cond, t = rand(18, 3, 1, 32), rand(19, 3, 4, 48), np.array([901, 301, 1])
    mask = valid_mask(3, 4)
    ref = JDenoiser(nfeats=263, latent_dim=(1, 32), ff_size=16, num_layers=3, dropout=0.0,
                    text_encoded_dim=48, md_trans=False)
    ref = jax.jit(lambda p, *a: ref.apply(p, *a[:3], cond_mask=a[3]))(
        params, *map(jnp.asarray, (x, t, cond, mask)))
    ours = den(*map(torch.as_tensor, (x, t, cond)), cond_mask=torch.as_tensor(mask))
    close(ours, ref)
    assert not np.allclose(ours.detach().numpy(),
                           den(*map(torch.as_tensor, (x, t, cond))).detach().numpy(), atol=1e-3)


DROPOUT_MODULES = {
    "encoder_layer": (lambda p: transformer.TransformerEncoderLayer(32, 2, 48, "gelu", p),
                      lambda: (rand(20, 3, 6, 32),)),
    "decoder_layer": (lambda p: transformer.TransformerDecoderLayer(32, 1, 40, "gelu", p),
                      lambda: (rand(21, 2, 5, 32), rand(22, 2, 3, 32))),
    "md_layer": (lambda p: stylization.MdTransformerLayer(32, 1, ffn_dim=16, dropout=p),
                 lambda: (rand(23, 3, 1, 32), rand(24, 3, 2, 32), rand(25, 3, 1, 32))),
    "denoiser": (lambda p: Denoiser((1, 32), ff_size=16, num_layers=3, text_encoded_dim=32,
                                    dropout=p),
                 lambda: (rand(26, 3, 1, 32), np.array([981, 501, 21]), rand(27, 3, 2, 32))),
    "vae_decode": (lambda p: MotionVae(75, (1, 32), ff_size=16, num_layers=3, dropout=p),
                   lambda: (rand(28, 3, 1, 32), 20)),
}


@pytest.mark.parametrize("name", sorted(DROPOUT_MODULES))
def test_dropout_only_in_train_mode(name):
    """With dropout 0.3: in train mode two forwards under different seeds of
    torch's default generator differ; in eval mode the output equals the
    same weights' output at dropout 0, which matches the flax module
    (the parity tests above)."""
    make, inputs = DROPOUT_MODULES[name]
    module, plain = seeded(make(0.3), 30), seeded(make(0.0), 30)
    args = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in inputs()]
    run = (lambda m: m.decode(*args)) if name == "vae_decode" else (lambda m: m(*args))
    torch.testing.assert_close(run(module), run(plain), rtol=0, atol=0)
    module.train()
    torch.manual_seed(0)
    a = run(module)
    torch.manual_seed(1)
    b = run(module)
    torch.manual_seed(0)
    assert not torch.equal(a, b) and torch.equal(a, run(module))
    assert {m.p for m in module.modules() if isinstance(m, torch.nn.Dropout)} == {0.3}


def test_dropout_sites_match_jax():
    """One `nn.Dropout` at each JAX site: per MD layer the attention
    weights, the self-attention block's output/FFN sites, both stylization
    blocks and the stylized FFN; per VAE layer the attention weights (two
    in a decoder layer) and the layer's own; `StylizationBlock` keeps its
    state-dict keys (`out_layers.2.*`)."""
    count = lambda m: sum(isinstance(x, torch.nn.Dropout) for x in m.modules())  # noqa: E731
    assert count(stylization.MdTransformerLayer(32, 1, ffn_dim=16)) == 5
    assert count(transformer.TransformerEncoderLayer(32, 1, 16)) == 2
    assert count(transformer.TransformerDecoderLayer(32, 1, 16)) == 3
    assert count(MotionVae(75, (1, 32), ff_size=16, num_layers=3)) == 3 * 2 + 3 * 3
    block = stylization.StylizationBlock(32, 32, dropout=0.2)
    assert set(block.state_dict()) == {"emb_layers.1.weight", "emb_layers.1.bias", "norm.weight",
                                       "norm.bias", "out_layers.2.weight", "out_layers.2.bias"}
    assert block.out_layers[1].p == 0.2
