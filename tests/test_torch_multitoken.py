"""Multi-token latents (`latent_dim` [T, D] with T > 1) through the port's
DDIM samplers against the JAX package on the CPU, f32 against f32.

The JAX kernel `ddim_fused` takes any T on both block types: one latent
token runs `_md_layer_t1`, more the general `_md_layer` (self-attention of
the T latent rows over [x; cond; time], then the block-masked linear
cross-attention) or, on the token-concat path, `denoiser_apply_pure`
keeping the first T rows (`seeme_tpu/ops/denoiser_fused.py:284-318`,
`:339-432`). The port's plain twin is held to the JAX twin (its tanh GELU
set to the exact erf form) and to the flax module within 1e-4, its DDIM
loop to the exact JAX path (flax `Denoiser` under the `ddim_sample` scan)
within 1e-4 of max |z|, and to the Pallas kernel in interpret mode within
0.02 of max |z| (bf16 weights, tanh GELU). The three systems sample at T = 2
as the JAX compositions do with the same numpy noise, and route as the JAX
package routes; a SEE-ME model with the token-concat stack (`md_trans=False`,
the stage-1 ego presets') samples through kernel 5's route as the JAX
composition over the flax token-concat `Denoiser` does, at T = 1 and 2 and
one or two condition tokens. Sizes: latent width 32, 3 layers, 3 DDIM steps.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import jax.scipy.special
import numpy as np
import pytest
import torch

from seeme_tpu.core.smpl import synthetic_smpl as j_synthetic_smpl
from seeme_tpu.diffusion.sampling import ddim_sample
from seeme_tpu.diffusion.schedulers import DiffusionSchedule as JSchedule
from seeme_tpu.models.a2m import A2MConfig as JA2MConfig
from seeme_tpu.models.a2m import A2MSystem as JA2MSystem
from seeme_tpu.models.denoiser import Denoiser as JDenoiser
from seeme_tpu.models.seeme import SeeMeConfig as JSeeMeConfig
from seeme_tpu.models.seeme import SeeMeSystem as JSeeMeSystem
from seeme_tpu.models.t2m import T2MConfig as JT2MConfig
from seeme_tpu.models.t2m import T2MSystem as JT2MSystem
from seeme_tpu.ops import denoiser_fused as j_df
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.diffusion.schedulers import DiffusionSchedule
from seeme_tpu_torch.models import a2m as a2m_module
from seeme_tpu_torch.models import seeme as seeme_module
from seeme_tpu_torch.models import t2m as t2m_module
from seeme_tpu_torch.models.a2m import A2MConfig, A2MSystem
from seeme_tpu_torch.models.denoiser import Denoiser
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
from seeme_tpu_torch.nn.init import init_parameters_, perturb_parameters_
from seeme_tpu_torch.ops import denoiser_fused as dfu
from tools.convert_checkpoint import convert_mld_checkpoint

D, TEXT, STEPS, B = 32, 48, 3, 3
TOL, KERNEL_TOL = 1e-4, 0.02  # of max |z|: the exact JAX path; the bf16 tanh Pallas kernel


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


def exact_gelu(x, approximate=False):
    return 0.5 * x * (1.0 + jax.scipy.special.erf(x / np.sqrt(2.0)).astype(x.dtype))


_PAIRS = {}


def pair(md_trans, T):
    """A seeded, perturbed port denoiser at latent [T, 32], 3 layers, its
    state dict, the same weights as a JAX tree, and the flax module."""
    key = (md_trans, T)
    if key not in _PAIRS:
        text = D if md_trans else TEXT
        den = Denoiser((T, D), ff_size=16, num_layers=3, text_encoded_dim=text,
                       md_trans=md_trans)
        init_parameters_(den, torch.Generator().manual_seed(4 + T))
        perturb_parameters_(den, torch.Generator().manual_seed(104 + T))
        sd = den.requires_grad_(False).eval().state_dict()
        params = jax.tree.map(jnp.asarray, convert_mld_checkpoint(
            {f"denoiser.{k}": v.numpy() for k, v in sd.items()})["denoiser"])
        jden = JDenoiser(nfeats=75, latent_dim=(T, D), ff_size=16, num_layers=3, dropout=0.0,
                         text_encoded_dim=text, md_trans=md_trans)
        _PAIRS[key] = sd, params, jden, text
    return _PAIRS[key]


def cond_rows(seed, guidance, n_cond, width):
    """B condition rows, or [uncond; cond] with a zero uncond half at guidance > 1."""
    c = rand(seed, B, n_cond, width)
    return np.concatenate([np.zeros_like(c), c]) if guidance > 1 else c


@pytest.mark.parametrize("T", [2, 3])
def test_md_layer_matches_jax(T):
    """Every general MD layer of the stack, the port's `_md_layer` over the
    hoisted condition invariants against the JAX `_md_layer` (erf GELU)."""
    sd, params, _, _ = pair(True, T)
    x, xf, emb = rand(1, B, T, D), rand(2, B, 2, D), rand(3, B, 1, D)
    inv = dfu.md_step_invariants(sd, torch.as_tensor(xf), 3)
    enc = params["params"]["encoder"]
    names = {"encoder.input_blocks.0": "input_0", "encoder.middle_block": "middle",
             "encoder.output_blocks.0": "output_0"}
    for name, jname in names.items():
        ours = dfu._md_layer(sd, name, torch.as_tensor(x), inv[name], torch.as_tensor(emb))
        with mock.patch.object(jax.nn, "gelu", exact_gelu):
            ref = j_df._md_layer(enc[jname], *map(jnp.asarray, (x, xf, emb)))
        close(ours.numpy(), ref, TOL)


@pytest.mark.parametrize("T", [2, 3])
@pytest.mark.parametrize("md_trans", [True, False], ids=["md", "token"])
def test_denoiser_apply_pure_matches_jax(md_trans, T):
    """The plain twin at T tokens against the JAX twin (erf GELU) and the
    flax module, within 1e-4; on the token path the first T rows are kept."""
    sd, params, jden, text = pair(md_trans, T)
    x, cond, t = rand(4, B, T, D), rand(5, B, 2, text), np.array([981, 401, 1])
    ours = dfu.denoiser_apply_pure(sd, *map(torch.as_tensor, (x, t, cond)), num_layers=3,
                                   md_trans=md_trans)
    assert ours.shape == (B, T, D)
    with mock.patch.object(jax.nn, "gelu", exact_gelu):
        ref = j_df.denoiser_apply_pure(params, *map(jnp.asarray, (x, t, cond)), 3,
                                       md_trans=md_trans)
    close(ours.numpy(), ref, TOL)
    close(ours.numpy(), jax.jit(jden.apply)(params, *map(jnp.asarray, (x, t, cond))), TOL)


def exact_jax_ddim(params, jden, cond, z0, guidance):
    fn = lambda x, t, r: jden.apply(params, x, t, jnp.asarray(cond))  # noqa: E731
    return np.asarray(ddim_sample(fn, JSchedule(), jax.random.PRNGKey(0), z0.shape,
                                  num_inference_steps=STEPS, guidance_scale=guidance,
                                  z_init=z0))


@pytest.mark.parametrize("guidance", [1.0, 2.5])
@pytest.mark.parametrize("T", [2, 3])
@pytest.mark.parametrize("md_trans", [True, False], ids=["md", "token"])
def test_ddim_fused_plain_matches_exact_jax_path(md_trans, T, guidance):
    """Each wrapper on CPU tensors runs `ddim_fused_plain` at T tokens,
    counts no launch, and meets the flax `Denoiser` under `ddim_sample`."""
    sd, params, jden, text = pair(md_trans, T)
    z0, cond = rand(6, B, T, D), cond_rows(7, guidance, 2, text)
    ref = exact_jax_ddim(params, jden, cond, z0, guidance)
    fn = dfu.ddim_fused if md_trans else dfu.ddim_fused_tok
    before = fn.launches
    ours = fn(sd, torch.as_tensor(cond), torch.as_tensor(z0), DiffusionSchedule(), STEPS,
              num_layers=3, guidance_scale=guidance)
    assert fn.launches == before and ours.shape == (B, T, D)
    close(ours.numpy(), ref, TOL)


@pytest.mark.parametrize("guidance", [1.0, 2.5])
@pytest.mark.parametrize("md_trans", [True, False], ids=["md", "token"])
def test_ddim_fused_plain_against_pallas_interpret(md_trans, guidance):
    """The Pallas `ddim_fused` at T = 2 in interpret mode (bf16 weights, tanh
    GELU, its general branch): 0.02 x max |z|, as tests/test_pallas_ops.py
    holds the T = 1 kernel."""
    T = 2
    sd, params, _, text = pair(md_trans, T)
    z0, cond = rand(8, B, T, D), cond_rows(9, guidance, 2, text)
    jarr = j_df.ddim_schedule_arrays(JSchedule(), STEPS)
    orig = j_df.pl.pallas_call
    with mock.patch.object(j_df.pl, "pallas_call",
                           lambda *a, **k: orig(*a, **{**k, "interpret": True})):
        ref = np.asarray(j_df.ddim_fused(params, jnp.asarray(cond), jnp.asarray(z0), *jarr,
                                         num_steps=STEPS, num_layers=3,
                                         guidance_scale=guidance, md_trans=md_trans))
    ours = dfu.ddim_fused_plain(sd, torch.as_tensor(cond), torch.as_tensor(z0),
                                DiffusionSchedule(), STEPS, 3, guidance, md_trans=md_trans)
    close(ours.numpy(), ref, KERNEL_TOL)


# ------------------------------------------------------------------ systems

SMALL_EGO = dict(latent_dim=(2, D), ff_size=16, num_layers=3, num_inference_timesteps=STEPS,
                 scene_points=64, scene_feat_dim=D)


@pytest.mark.parametrize("guidance", [1.0, 2.5])
def test_seeme_samples_two_tokens_as_jax(guidance):
    """`SeeMeSystem` at latent [2, 32]: `encode_conditioning` ->
    `sample_from_cond(z_init=...)` against the JAX composition (`ddim_sample`
    over the flax `Denoiser`, then `vae.decode`, then `eval_fk`)."""
    data = SyntheticEgoDataset(B, 60, scene_points=64, seed=0)
    system = SeeMeSystem(SeeMeConfig(guidance_scale=guidance, **SMALL_EGO), synthetic_smpl(256),
                         data.mean, data.std, device="cpu", seed=1)
    perturb_parameters_(system, torch.Generator().manual_seed(2))
    jsystem = JSeeMeSystem(JSeeMeConfig(guidance_scale=guidance, **SMALL_EGO),
                           j_synthetic_smpl(256), data.mean, data.std)
    params = jax.tree.map(jnp.asarray, convert_mld_checkpoint(
        {k: v.numpy() for k, v in system.state_dict().items()}))
    nb = data.batch(0, B)
    tb, jb = to_torch(nb, "cpu"), {k: jnp.asarray(v) for k, v in nb.items()}
    z0 = rand(10, B, 2, D)
    cond = system.encode_conditioning(tb)
    jcond = jax.jit(jsystem.encode_conditioning)(params, jb)
    feats = system.sample_from_cond(cond, z_init=torch.as_tensor(z0))
    z = ddim_sample(lambda x, t, r: jsystem.denoiser.apply(params["denoiser"], x, t, jcond),
                    jsystem.schedule, jax.random.PRNGKey(0), z0.shape,
                    num_inference_steps=STEPS, guidance_scale=guidance, z_init=z0)
    jfeats = jax.jit(lambda p, z: jsystem.vae.apply(p, z, 60, method=jsystem.vae.decode))(
        params["vae"], z)
    close(feats.numpy(), jfeats, TOL)
    out, jout = system.eval_fk(tb, feats), jax.jit(jsystem.eval_fk)(params, jb, jfeats)
    close(out["joints_rst"].numpy(), jout["joints_rst"], TOL)


@pytest.mark.parametrize("condition,T,guidance", [((), 1, 1.0), ((), 2, 2.5),
                                                   (("interactee", "scene"), 1, 2.5),
                                                   (("interactee", "scene"), 2, 1.0)])
def test_seeme_token_concat_samples_as_jax(condition, T, guidance):
    """A SEE-ME model with `md_trans=False` (the stage-1 ego presets' stack,
    TRAIN.ABLATION.MD_TRANS false) samples through kernel 5's route (its
    plain version here), at one and two latent tokens and one (the empty
    condition set's zero token) or two condition tokens, against the JAX
    composition: `ddim_sample` over the flax token-concat `Denoiser`, then
    `vae.decode` and `eval_fk`."""
    data = SyntheticEgoDataset(B, 60, scene_points=64, seed=0)
    kw = dict(SMALL_EGO, latent_dim=(T, D), md_trans=False, condition=condition,
              guidance_scale=guidance)
    system = SeeMeSystem(SeeMeConfig(**kw), synthetic_smpl(256), data.mean, data.std,
                         device="cpu", seed=1)
    perturb_parameters_(system, torch.Generator().manual_seed(2))
    jsystem = JSeeMeSystem(JSeeMeConfig(**kw), j_synthetic_smpl(256), data.mean, data.std)
    params = jax.tree.map(jnp.asarray, convert_mld_checkpoint(
        {k: v.numpy() for k, v in system.state_dict().items()}))
    nb = data.batch(0, B)
    tb, jb = to_torch(nb, "cpu"), {k: jnp.asarray(v) for k, v in nb.items()}
    z0 = rand(16 + T, B, T, D)
    cond = system.encode_conditioning(tb)
    jcond = jax.jit(jsystem.encode_conditioning)(params, jb)
    close(cond.numpy(), jcond, TOL)
    calls = []
    with mock.patch.object(seeme_module, "ddim_fused_tok",
                           side_effect=lambda *a, **k: calls.append(1) or dfu.ddim_fused_tok(*a, **k)):
        feats = system.sample_from_cond(cond, z_init=torch.as_tensor(z0))
    assert calls == [1]
    z = ddim_sample(lambda x, t, r: jsystem.denoiser.apply(params["denoiser"], x, t, jcond),
                    jsystem.schedule, jax.random.PRNGKey(0), z0.shape,
                    num_inference_steps=STEPS, guidance_scale=guidance, z_init=z0)
    jfeats = jax.jit(lambda p, z: jsystem.vae.apply(p, z, 60, method=jsystem.vae.decode))(
        params["vae"], z)
    close(feats.numpy(), jfeats, TOL)
    out, jout = system.eval_fk(tb, feats), jax.jit(jsystem.eval_fk)(params, jb, jfeats)
    close(out["joints_rst"].numpy(), jout["joints_rst"], TOL)


@pytest.mark.parametrize("guidance", [1.0, 7.5])
def test_t2m_samples_two_tokens_as_jax(guidance):
    """`T2MSystem.sample(z_init=...)` at latent [2, 32], the pooled VAE
    model, against the JAX `sample(z_init=...)` (its scan on the CPU); the
    port takes kernel 5's route (its plain version here)."""
    small = dict(latent_dim=(2, D), ff_size=16, num_layers=3, text_encoded_dim=TEXT, max_len=24,
                 num_inference_timesteps=STEPS)
    mean, std = np.zeros(263, np.float32), np.ones(263, np.float32)
    system = T2MSystem(T2MConfig(guidance_scale=guidance, **small), mean, std, device="cpu",
                       seed=1)
    perturb_parameters_(system, torch.Generator().manual_seed(2))
    jsystem = JT2MSystem(JT2MConfig(guidance_scale=guidance, dropout=0.0, **small))
    params = jax.tree.map(jnp.asarray, convert_mld_checkpoint(
        {k: v.numpy() for k, v in system.state_dict().items()}))
    text, lengths, z0 = rand(11, B, TEXT), np.array([24, 16, 9], np.int32), rand(12, B, 2, D)
    calls = []
    with mock.patch.object(t2m_module, "ddim_fused_tok",
                           side_effect=lambda *a, **k: calls.append(1) or dfu.ddim_fused_tok(*a, **k)):
        feats = system.sample(torch.as_tensor(text), lengths=torch.as_tensor(lengths),
                              z_init=torch.as_tensor(z0))
    assert calls == [1]
    jfeats = jax.jit(lambda p, t, n, z: jsystem.sample(p, t, jax.random.PRNGKey(0), lengths=n,
                                                       z_init=z))(
        params, jnp.asarray(text), jnp.asarray(lengths), jnp.asarray(z0))
    close(feats.numpy(), jfeats, TOL)


@pytest.mark.parametrize("guidance", [1.0, 7.5])
def test_a2m_samples_two_tokens_as_jax(guidance):
    """`A2MSystem.sample(z_init=...)` at latent [2, 32] through kernel 5's
    route against `embed_action` -> `ddim_sample(z_init=...)` ->
    `vae.decode` in JAX."""
    small = dict(num_frames=16, num_classes=12, latent_dim=(2, D), ff_size=16, num_layers=3,
                 num_inference_timesteps=STEPS, dropout=0.0, guidance_scale=guidance)
    system = A2MSystem(A2MConfig(**small), synthetic_smpl(128), device="cpu", seed=1)
    perturb_parameters_(system, torch.Generator().manual_seed(2))
    jsystem = JA2MSystem(JA2MConfig(**small))
    sd = {k: v.detach().numpy().copy() for k, v in system.state_dict().items()}
    params = convert_mld_checkpoint(sd)
    params["embed_action"] = {"params": {"action_embedding": sd["embed_action.action_embedding"]}}
    params = jax.tree.map(jnp.asarray, params)
    ids, lengths, z0 = np.array([0, 5, 11], np.int32), np.array([16, 12, 8]), rand(13, B, 2, D)

    def compose(p, ids, lengths, z):
        cond = jsystem.embed_action.apply(p["embed_action"], ids)
        if guidance > 1.0:
            cond = jnp.concatenate([jnp.zeros_like(cond), cond])
        z = ddim_sample(lambda x, t, r: jsystem.denoiser.apply(p["denoiser"], x, t, cond),
                        jsystem.schedule, jax.random.PRNGKey(0), z.shape, STEPS,
                        guidance_scale=guidance, z_init=z)
        return jsystem.vae.apply(p["vae"], z, 16, lengths, method=jsystem.vae.decode)

    calls = []
    with mock.patch.object(a2m_module, "ddim_fused_tok",
                           side_effect=lambda *a, **k: calls.append(1) or dfu.ddim_fused_tok(*a, **k)):
        got = system.sample(torch.as_tensor(ids), torch.as_tensor(lengths),
                            z_init=torch.as_tensor(z0))
    assert calls == [1]
    want = jax.jit(compose)(params, jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(z0))
    close(got.numpy(), want, TOL)


@pytest.mark.parametrize("T,entry", [(1, "ddim_fused_grid"), (2, "ddim_fused"),
                                     (3, "ddim_fused")])
def test_grid_variant_routes_multi_token_latents_to_ddim_fused(T, entry):
    """`fused_variant="grid"` takes the grid entry at one latent token and
    `ddim_fused` past it (`seeme_tpu/models/seeme.py:532-534`)."""
    data = SyntheticEgoDataset(B, 60, scene_points=64, seed=0)
    cfg = SeeMeConfig(fused_variant="grid", **{**SMALL_EGO, "latent_dim": (T, D)})
    system = SeeMeSystem(cfg, synthetic_smpl(256), data.mean, data.std, device="cpu", seed=1)
    calls = []
    spies = {name: (lambda *a, _n=name, **k: calls.append(_n) or getattr(dfu, _n)(*a, **k))
             for name in ("ddim_fused", "ddim_fused_grid")}
    cond = torch.as_tensor(rand(14, B, 2, D))
    with mock.patch.object(seeme_module, "ddim_fused", side_effect=spies["ddim_fused"]), \
            mock.patch.object(seeme_module, "ddim_fused_grid",
                              side_effect=spies["ddim_fused_grid"]):
        feats = system.sample_from_cond(cond, z_init=torch.as_tensor(rand(15, B, T, D)))
    assert calls == [entry] and feats.shape == (B, 60, cfg.nfeats)
