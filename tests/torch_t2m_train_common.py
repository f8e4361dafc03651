"""Shared helpers of the text-to-motion training tests (`tests/test_torch_t2m_train*.py`).

The port's text-to-motion model against the JAX package on the CPU in
f32: both denoiser archs with and without `diffusion_only` and a condition
mask, the VAE at its own widths, the two losses and their gradients (the
diffusion-only masked target included), `reconstruct`, `sample` on its
three routes, the text fallback, the presets and the train CLI.

Weights go from the JAX `init_params` trees through `from_jax_params` (a
strict load), or from the port through
`tools/convert_checkpoint.py::convert_mld_checkpoint`. The JAX losses draw
from key splits inside `vae_loss` / `diffusion_loss`
(`seeme_tpu/models/t2m.py:125`, `:160`); the tests re-derive those draws
from the same keys and hand them to the port as `draws`, as
`tests/test_torch_train.py` does. Dropout is 0 on both sides. Sizes: d 32,
3 layers (2 for the plain decoder stack), 24 frames, 8 text tokens.
Tolerances: 1e-5 for modules (of the output's max |.|), 1e-5 relative for
loss terms and 1e-4 of each tensor's max |g| for gradients (with a 1e-8
floor for gradients that are zero but for rounding), and 1e-4 of max
|features| for `sample`, whose 5 DDIM steps compound the module error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.config.loader import Config
from seeme_tpu.data.humanml import HumanML3DDataModule as JDataModule
from seeme_tpu.models.t2m import T2MConfig as JConfig
from seeme_tpu.models.t2m import T2MSystem as JSystem
from seeme_tpu_torch.convert import from_jax_params
from seeme_tpu_torch.data.synthetic import to_torch
from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
from seeme_tpu_torch.nn.init import perturb_parameters_
from tools.convert_checkpoint import convert_mld_checkpoint

B, W, TEXT, T, NTOK, STEPS = 3, 32, 48, 24, 8, 5
MODULE_RTOL, LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR, SAMPLE_RTOL = 1e-5, 1e-5, 1e-4, 1e-8, 1e-4
SMALL = dict(latent_dim=(1, W), ff_size=16, num_layers=3, text_encoded_dim=TEXT, max_len=T,
             num_inference_timesteps=STEPS, dropout=0.0)
JAX_FIELDS = {f.name for f in dataclasses.fields(JConfig)} - {"use_fused"}


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def close(got, want, rtol, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30), err_msg=msg)


@pytest.fixture(scope="module")
def jdm():
    cfg = Config({"DEBUG": True, "DATASET": {"SAMPLER": {"MAX_LEN": T, "MIN_LEN": 8}},
                  "model": {"denoiser": {"params": {"text_encoded_dim": TEXT}}}})
    return JDataModule(cfg)


def token_mask(seed):
    """(B, NTOK) valid-token mask, at least one valid token a row."""
    m = np.random.RandomState(seed).rand(B, NTOK) < 0.6
    m[:, 0] = True
    return m


def load_jax_tree(system, tree):
    system.load_state_dict(from_jax_params(jax.tree.map(np.asarray, tree)), strict=True)


def build(jdm, seed=1, **kw):
    """The same weights in both packages: the JAX init tree, perturbed on
    the port side, then carried back through `convert_mld_checkpoint`."""
    cfg = T2MConfig(**{**SMALL, **kw})
    jcfg = JConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in JAX_FIELDS})
    jsystem = JSystem(jcfg, feats2joints=jdm.feats2joints)
    system = T2MSystem(cfg, jdm.mean, jdm.std, device="cpu", seed=seed)
    load_jax_tree(system, jsystem.init_params(jax.random.PRNGKey(seed)))
    perturb_parameters_(system, torch.Generator().manual_seed(seed + 1))
    params = jax.tree.map(lambda a: jnp.array(a, copy=True), convert_mld_checkpoint(
        {k: v.detach().numpy().copy() for k, v in system.state_dict().items()}))
    return system, jsystem, params


def batch(jdm, text_mask=False):
    data = jdm._sets["test"]
    items = [data[i] for i in range(B)]
    out = {"motion": np.stack([it["motion"] for it in items]),
           "length": np.stack([it["length"] for it in items])}
    if text_mask:
        out["text_emb"] = rand(3, B, NTOK, TEXT)
        out["text_mask"] = token_mask(4)
    else:
        out["text_emb"] = np.stack([it["text_emb"] for it in items])
    return to_torch(out, "cpu"), {k: jnp.asarray(v) for k, v in out.items()}


DENOISER_CASES = {f"{name}-{'mask' if masked else 'nomask'}": (arch, novae, False, masked)
                  for name, arch, novae in (("enc", "trans_enc", False),
                                            ("enc-novae", "trans_enc", True),
                                            ("dec", "trans_dec", False),
                                            ("dec-novae", "trans_dec", True))
                  for masked in (False, True)}


DENOISER_CASES["md-nomask"] = ("trans_enc", False, True, False)


def jax_draws(jsystem, stage, jb, rng):
    """The draws of the JAX `vae_loss` / `diffusion_loss` from `rng`."""
    latent = (B, 1, W)
    if stage == "vae":
        _, z_rng = jax.random.split(rng)
        return {"eps": torch.tensor(np.asarray(jax.random.normal(z_rng, latent)))}
    z_rng, m_rng, t_rng, n_rng, _ = jax.random.split(rng, 5)
    z_shape = jb["motion"].shape if jsystem.diffusion_only else latent
    draws = {"drop": jax.random.bernoulli(m_rng, jsystem.cfg.guidance_uncondp, (B, 1, 1)),
             "noise": jax.random.normal(n_rng, z_shape),
             "timesteps": jax.random.randint(t_rng, (B,), 0, 1000)}
    if not jsystem.diffusion_only:
        draws["eps"] = jax.random.normal(z_rng, latent)
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


LOSS_CASES = {
    "vae": ("vae", {}, False),
    "diffusion-g1": ("diffusion", {"guidance_scale": 1.0}, False),
    "diffusion-g7.5-tokens": ("diffusion", {}, True),
    "novae-dec": ("diffusion", {"vae_type": "no", "arch": "trans_dec", "num_layers": 2,
                                "num_heads": 2}, False),
    "novae-enc-tokens": ("diffusion", {"vae_type": "no"}, True),
}


SAMPLE_CASES = {
    "kernel-g1": ({"guidance_scale": 1.0}, False, True),
    "kernel-g7.5": ({}, False, True),
    "kernel-heads2-ff64": ({"num_heads": 2, "ff_size": 2 * W}, False, True),
    "kernel-heads4-ff128-g1": ({"num_heads": 4, "ff_size": 4 * W, "guidance_scale": 1.0}, False,
                               True),
    "scan-tokens": ({}, True, False),
    "scan-novae-dec": ({"vae_type": "no", "arch": "trans_dec", "num_layers": 2, "num_heads": 2},
                       False, False),
    "scan-novae-dec-tokens": ({"vae_type": "no", "arch": "trans_dec", "num_layers": 2}, True,
                              False),
}


TINY = ["model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
        f"model.text_encoded_dim={TEXT}", f"model.max_len={T}", "model.min_len=8",
        "train.val_every_steps=1"]


def write_release(root, nfeats=263, ids=("000001", "000002", "000003", "M000004", "000005")):
    rng = np.random.RandomState(3)
    (root / "new_joint_vecs").mkdir(parents=True)
    (root / "texts").mkdir()
    lengths = {"000001": 50, "000002": 63, "000003": 30, "M000004": 210, "000005": 45}
    for i in ids:
        np.save(root / "new_joint_vecs" / f"{i}.npy", rng.randn(lengths[i], nfeats).astype(np.float32))
        (root / "texts" / f"{i}.txt").write_text(
            f"a person walks number {i}#a/DET person/NOUN#0.0#0.0\nsecond caption#x/NOUN#0.0#0.0\n")
    for name in ("Mean", "Std", "Mean_eval", "Std_eval"):
        v = rng.rand(nfeats).astype(np.float32) + (0.5 if "Std" in name else 0.0)
        np.save(root / f"{name}.npy", v)
    (root / "train.txt").write_text("\n".join([*ids, "999999"]) + "\n")
    (root / "val.txt").write_text("000002\n000005\n")
    (root / "test.txt").write_text("000001\n000003\nM000004\n000005\n")
    return root


def same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for k in a:
            if k == "text":
                assert a[k] == b[k]
            else:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
