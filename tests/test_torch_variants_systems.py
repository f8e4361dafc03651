"""The ego variants' VAE forms and composed systems against the JAX package
(helpers in `torch_variants_common.py`; see `test_torch_variants.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.diffusion.sampling import ddim_sample
from seeme_tpu.models.vae import MotionVae as JMotionVae
from seeme_tpu_torch.data.synthetic import to_torch
from seeme_tpu_torch.models.vae import MotionVae
from seeme_tpu_torch.nn.init import init_parameters_, perturb_parameters_
from tools.convert_checkpoint import convert_motion_vae
from torch_variants_common import (
    B,
    build,
    STEPS,
    T,
    VARIANTS,
    W,
)
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("arch,mlp_dist", [("encoder_decoder", True), ("all_encoder", False),
                                           ("all_encoder", True)])
def test_vae_variants_match_jax(arch, mlp_dist):
    """`mlp_dist` (latent_size tokens through `dist_layer`) and the
    all-encoder decoder: encode and decode within 1e-5 of the flax VAE on
    the port's weights (`convert_motion_vae`)."""
    vae = MotionVae(75, (1, W), 16, 3, dropout=0.0, arch=arch, mlp_dist=mlp_dist)
    init_parameters_(vae, torch.Generator().manual_seed(0))
    perturb_parameters_(vae, torch.Generator().manual_seed(1))
    assert ("dist_layer.weight" in vae.state_dict()) == mlp_dist
    params = jax.tree.map(jnp.asarray, convert_motion_vae(
        {k: v.numpy() for k, v in vae.state_dict().items()}, 3, arch=arch))
    jvae = JMotionVae(75, (1, W), 16, 3, dropout=0.0, arch=arch, mlp_dist=mlp_dist)
    x = np.random.RandomState(2).randn(B, T, 75).astype(np.float32)
    lengths = np.array([T, 41, 17])
    with torch.no_grad():
        mu, logvar = vae.encode(torch.as_tensor(x), torch.as_tensor(lengths))
        out = vae.decode(mu, T, torch.as_tensor(lengths))
    jmu, jlogvar = jvae.apply(params, jnp.asarray(x), jnp.asarray(lengths), method=jvae.encode)
    jout = jvae.apply(params, jmu, T, jnp.asarray(lengths), method=jvae.decode)
    for a, b in ((mu, jmu), (logvar, jlogvar), (out, jout)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    with pytest.raises(ValueError, match="arch"):
        MotionVae(75, arch="trans_dec")


@pytest.mark.parametrize("name,guidance", [("image", 1.0), ("image", 2.5), ("gimo", 1.0),
                                           ("rot6d", 1.0), ("no-transl", 1.0),
                                           ("estimate-interactee", 1.0)])
def test_variant_matches_jax_composition(name, guidance):
    """Condition tokens, sampled features, joints and orientations of each
    variant against the JAX package (the image's uncond half at guidance
    2.5 from a zeroed image)."""
    data, system, jsystem, params = build(VARIANTS[name], guidance)
    nb = data.batch(0, B)
    tb, jb = to_torch(nb, "cpu"), {k: jnp.asarray(v) for k, v in nb.items()}
    z0 = np.random.RandomState(3).randn(B, 1, W).astype(np.float32)

    cond = system.encode_conditioning(tb)
    jcond = jax.jit(jsystem.encode_conditioning)(params, jb)
    n_tok = len(system.cfg.condition)
    assert cond.shape == ((2 if guidance > 1 else 1) * B, n_tok, W)
    np.testing.assert_allclose(cond.numpy(), np.asarray(jcond), atol=1e-4)

    feats = system.sample_from_cond(cond, z_init=torch.as_tensor(z0))
    z = ddim_sample(lambda x, t, r: jsystem.denoiser.apply(params["denoiser"], x, t, jcond),
                    jsystem.schedule, jax.random.PRNGKey(0), z0.shape,
                    num_inference_steps=STEPS, guidance_scale=guidance, z_init=z0)
    jfeats = jax.jit(lambda p, z: jsystem.vae.apply(p, z, T, method=jsystem.vae.decode))(
        params["vae"], z)
    assert feats.shape == (B, T, system.cfg.nfeats)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats),
                               atol=1e-4 * float(np.abs(jfeats).max()))

    out, jout = system.eval_fk(tb, feats), jax.jit(jsystem.eval_fk)(params, jb, jfeats)
    for k in ("joints_rst", "joints_ref", "joints_int", "quat_rst", "quat_ref"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["gimo", "rot6d", "no-transl"])
def test_feats_to_vertices_matches_jax(name):
    data, system, jsystem, params = build(VARIANTS[name])
    nb = data.batch(0, B)
    tb = to_torch(nb, "cpu")
    raw = system.renorm(system.actor_features(tb, 0))
    betas, transl = tb["betas"][:, 0], tb["transl"][:, 0]
    ours = system.feats_to_vertices(raw, betas, transl)
    ref = jsystem.feats_to_vertices(jnp.asarray(raw.numpy()), jnp.asarray(nb["betas"][:, 0]),
                                    jnp.asarray(nb["transl"][:, 0]))
    assert ours.shape == (B, T, 256, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
