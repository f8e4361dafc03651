"""The port's text-to-motion model against the JAX package on the CPU in
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
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.config import load_config
from seeme_tpu.config.build import build_t2m_system
from seeme_tpu.config.loader import Config
from seeme_tpu.data.humanml import HumanML3DDataModule as JDataModule
from seeme_tpu.models.denoiser import Denoiser as JDenoiser
from seeme_tpu.models.t2m import T2MConfig as JConfig
from seeme_tpu.models.t2m import T2MSystem as JSystem
from seeme_tpu.models.text_encoder import ClipTextEncoder as JTextEncoder
from seeme_tpu.train.state import STAGE_TRAINABLE as J_STAGE_TRAINABLE
from seeme_tpu_torch.config.humanml3d import T2M_PRESETS
from seeme_tpu_torch.config.presets import PRESETS
from seeme_tpu_torch.convert import from_jax_params
from seeme_tpu_torch.data.humanml import HumanML3DDataModule
from seeme_tpu_torch.data.registry import get_datamodule
from seeme_tpu_torch.data.synthetic import to_torch
from seeme_tpu_torch.models.denoiser import Denoiser
from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
from seeme_tpu_torch.models.text_encoder import ClipTextEncoder
from seeme_tpu_torch.nn.init import perturb_parameters_
from seeme_tpu_torch.train.__main__ import main
from seeme_tpu_torch.train.state import set_stage
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


# ------------------------------------------------------------------ modules

DENOISER_CASES = {f"{name}-{'mask' if masked else 'nomask'}": (arch, novae, False, masked)
                  for name, arch, novae in (("enc", "trans_enc", False),
                                            ("enc-novae", "trans_enc", True),
                                            ("dec", "trans_dec", False),
                                            ("dec-novae", "trans_dec", True))
                  for masked in (False, True)}
DENOISER_CASES["md-nomask"] = ("trans_enc", False, True, False)


@pytest.mark.parametrize("case", list(DENOISER_CASES))
def test_denoiser_matches_flax(case):
    """Every arch from the JAX init tree (`from_jax_params`, strict): the
    token-concat and MD U-skip stacks, the plain decoder with `mem_pos`,
    each over latents or (diffusion-only) over features with the length
    mask, with and without a condition mask (the MD stack, which no masked
    caller reaches, refuses one); 2 heads."""
    arch, diffusion_only, md_trans, masked = DENOISER_CASES[case]
    layers = 2 if arch == "trans_dec" else 3
    kw = dict(latent_dim=(1, W), ff_size=16, num_layers=layers, num_heads=2,
              text_encoded_dim=TEXT, md_trans=md_trans, arch=arch, diffusion_only=diffusion_only,
              dropout=0.0)
    jden = JDenoiser(nfeats=263, **{k: tuple(v) if k == "latent_dim" else v
                                    for k, v in kw.items()})
    den = Denoiser(nfeats=263, **kw)
    sample = rand(5, B, T, 263) if diffusion_only else rand(5, B, 1, W)
    t, cond = np.array([3, 500, 999]), rand(6, B, NTOK, TEXT)
    lengths = np.array([T, 9, 17])
    mask = token_mask(7) if masked else None
    params = jden.init(jax.random.PRNGKey(2), sample, t, cond, lengths if diffusion_only else None,
                       cond_mask=mask)
    state = from_jax_params({"denoiser": jax.tree.map(np.asarray, params)})
    den.load_state_dict({k[len("denoiser."):]: v for k, v in state.items()}, strict=True)
    den.eval()
    want = jax.jit(lambda p, m: jden.apply(p, sample, t, cond, lengths if diffusion_only else None,
                                           cond_mask=m))(params, mask)
    got = den(torch.as_tensor(sample), torch.as_tensor(t), torch.as_tensor(cond),
              cond_mask=None if mask is None else torch.as_tensor(mask),
              lengths=torch.as_tensor(lengths) if diffusion_only else None)
    close(got.detach().numpy(), want, MODULE_RTOL)
    if diffusion_only:
        assert not got[1, 9:].any()
    if md_trans:
        with pytest.raises(ValueError, match="md_trans"):
            den(torch.as_tensor(sample), torch.as_tensor(t), torch.as_tensor(cond),
                cond_mask=torch.as_tensor(token_mask(7)))


def test_vae_at_its_own_widths_matches_flax(jdm):
    """`vae_num_layers` / `vae_ff_size` apart from the denoiser's (5 x 24 vs
    3 x 16), and `mlp_dist`: encode and decode as the flax VAE."""
    system, jsystem, params = build(jdm, vae_num_layers=5, vae_ff_size=24, mlp_dist=True)
    assert len(system.vae.encoder.input_blocks) == 2 and len(system.denoiser.encoder.input_blocks) == 1
    assert system.vae.encoder.middle_block.linear1.out_features == 24
    tb, jb = batch(jdm)
    mu, logvar = system.vae.encode(tb["motion"], tb["length"])
    jmu, jlogvar = jax.jit(lambda p, m, n: jsystem.vae.apply(p, m, n, method=jsystem.vae.encode))(
        params["vae"], jb["motion"], jb["length"])
    close(mu.detach().numpy(), jmu, MODULE_RTOL)
    close(logvar.detach().numpy(), jlogvar, MODULE_RTOL)
    out = system.vae.decode(mu, T, tb["length"])
    jout = jax.jit(lambda p, z, n: jsystem.vae.apply(p, z, T, n, method=jsystem.vae.decode))(
        params["vae"], jmu, jb["length"])
    close(out.detach().numpy(), jout, MODULE_RTOL)


# -------------------------------------------------------------------- losses

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


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_gradients_match_jax(case, jdm):
    """Every loss term within 1e-5 relative and every trainable gradient
    within 1e-4 of its tensor's max |g|; frozen tensors get none. The
    diffusion-only cases hold the masked target; rng 5 drops one sample's
    text (its draw is checked)."""
    stage, kw, tokens = LOSS_CASES[case]
    system, jsystem, params = build(jdm, **kw)
    tb, jb = batch(jdm, text_mask=tokens)
    rng = jax.random.PRNGKey(5)
    trainable = J_STAGE_TRAINABLE[stage]
    fn = jsystem.vae_loss if stage == "vae" else jsystem.diffusion_loss

    def compute(p, b, r):
        p = {k: (v if k in trainable else jax.lax.stop_gradient(v)) for k, v in p.items()}
        return fn(p, b, r)

    (jloss, jterms), jgrads = jax.jit(jax.value_and_grad(compute, has_aux=True))(params, jb, rng)
    draws = jax_draws(jsystem, stage, jb, rng)
    if stage == "diffusion":
        assert draws["drop"].any() and not draws["drop"].all()
    ours = set_stage(system, stage)
    loss, terms = (system.vae_loss if stage == "vae" else system.diffusion_loss)(tb, draws=draws)
    loss.backward()
    assert set(terms) == set(jterms)
    for k, v in terms.items():
        np.testing.assert_allclose(v.item(), float(jterms[k]), rtol=LOSS_RTOL, err_msg=k)
    ref = from_jax_params(jax.tree.map(np.asarray, jgrads))
    ids = {id(p) for p in ours}
    for name, p in system.named_parameters():
        if id(p) not in ids:
            assert p.grad is None, name
            continue
        g = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=max(GRAD_RTOL * float(np.abs(g).max()), GRAD_FLOOR),
                                   err_msg=name)


def test_draws_from_a_generator(jdm):
    """`loss_draws`: the stage's keys at the loss's shapes, a fresh draw per call."""
    system, _, _ = build(jdm)
    novae, _, _ = build(jdm, vae_type="no", arch="trans_dec")
    tb, _ = batch(jdm)
    gen = torch.Generator().manual_seed(0)
    assert set(system.loss_draws("vae", tb, gen)) == {"eps"}
    d = system.loss_draws("diffusion", tb, gen)
    assert d["drop"].shape == (B, 1, 1) and d["noise"].shape == (B, 1, W)
    assert d["drop"].dtype == torch.bool and d["timesteps"].max() < 1000
    d2 = novae.loss_draws("diffusion", tb, gen)
    assert "eps" not in d2 and d2["noise"].shape == (B, T, 263)
    assert not torch.equal(system.loss_draws("vae", tb, gen)["eps"],
                           system.loss_draws("vae", tb, gen)["eps"])


def test_reconstruct_matches_jax(jdm):
    system, jsystem, params = build(jdm)
    tb, jb = batch(jdm)
    rng = jax.random.PRNGKey(9)
    want = jax.jit(jsystem.reconstruct)(params, jb, rng)
    eps = torch.tensor(np.asarray(jax.random.normal(rng, (B, 1, W))))
    close(system.reconstruct(tb, eps=eps).numpy(), want, MODULE_RTOL * 10)


# ------------------------------------------------------------------ sampling

SAMPLE_CASES = {
    "kernel-g1": ({"guidance_scale": 1.0}, False, True),
    "kernel-g7.5": ({}, False, True),
    "scan-tokens": ({}, True, False),
    "scan-novae-dec": ({"vae_type": "no", "arch": "trans_dec", "num_layers": 2, "num_heads": 2},
                       False, False),
    "scan-novae-dec-tokens": ({"vae_type": "no", "arch": "trans_dec", "num_layers": 2}, True,
                              False),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_routes_match_jax(case, jdm, monkeypatch):
    """`sample(z_init=...)` against the JAX `sample(z_init=...)` (its scan
    on the CPU): the pooled VAE model through the token kernel's plain
    version, the token mode (a mask doubled under CFG) and the
    diffusion-only model through the loop; the route taken is counted."""
    from seeme_tpu_torch.models import t2m as t2m_mod

    kw, tokens, kernel = SAMPLE_CASES[case]
    system, jsystem, params = build(jdm, **kw)
    tb, jb = batch(jdm, text_mask=tokens)
    routes = {"kernel": 0, "loop": 0}
    for name, key in (("ddim_fused_tok", "kernel"), ("ddim_sample", "loop")):
        fn = getattr(t2m_mod, name)
        monkeypatch.setattr(t2m_mod, name, lambda *a, _f=fn, _k=key, **k: (
            routes.__setitem__(_k, routes[_k] + 1), _f(*a, **k))[1])
    shape = (B, T, 263) if system.diffusion_only else (B, 1, W)
    z0 = rand(8, *shape)
    mask = jb.get("text_mask")
    want = jax.jit(lambda p, e, n, m, z: jsystem.sample(p, e, jax.random.PRNGKey(0), lengths=n,
                                                        cond_mask=m, z_init=z))(
        params, jb["text_emb"], jb["length"], mask, jnp.asarray(z0))
    got = system.sample(tb["text_emb"], lengths=tb["length"], cond_mask=tb.get("text_mask"),
                        z_init=torch.as_tensor(z0))
    assert got.shape == (B, T, 263)
    close(got.numpy(), want, SAMPLE_RTOL)
    assert routes == ({"kernel": 1, "loop": 0} if kernel else {"kernel": 0, "loop": 1})


def test_more_than_eight_tokens_take_the_loop(jdm):
    system, _, _ = build(jdm)
    assert system.takes_kernel(8, None) and not system.takes_kernel(9, None)
    assert not system.takes_kernel(1, torch.ones(B, 1, dtype=torch.bool))
    out = system.sample(torch.randn(2, 12, TEXT), generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, T, 263) and torch.isfinite(out).all()


# -------------------------------------------------------------- text encoder

def test_text_fallback_and_token_mask_match_jax(tmp_path):
    texts = ["a person walks forward slowly", "jump", "the man turns left and raises both hands"]
    for path, hidden, mode in ((None, False, "clip"), (None, True, "clip_hidden"),
                               (str(tmp_path / "absent" / "clip-vit"), False, "clip"),
                               (str(tmp_path / "distilbert"), False, "bert")):
        ours = ClipTextEncoder(path, latent_dim=TEXT, last_hidden_state=hidden, max_length=6)
        ref = JTextEncoder(path, latent_dim=TEXT, last_hidden_state=hidden, max_length=6)
        assert ours.name == ref.name == mode and ours.is_fallback
        np.testing.assert_array_equal(ours(texts), ref(texts))
        mask = ours.token_mask(texts)
        if mode == "clip":
            assert mask is None and ref.token_mask(texts) is None
        else:
            np.testing.assert_array_equal(mask, ref.token_mask(texts))
            assert mask.shape == (3, 6) and mask[1].sum() == 1
    with pytest.raises(ValueError, match="not supported"):
        ClipTextEncoder("deps/t5-base")
    (tmp_path / "clip").mkdir()
    with pytest.raises(NotImplementedError):
        ClipTextEncoder(str(tmp_path / "clip"))


def test_captions_are_encoded_on_the_host(jdm):
    system, _, _ = build(jdm, text_encoded_dim=TEXT)
    b = system.encode_captions({"motion": np.zeros((2, T, 263)), "text": ["walk", "run fast"]})
    assert "text" not in b and b["text_emb"].shape == (2, 1, TEXT) and "text_mask" not in b
    tok = T2MSystem(T2MConfig(**SMALL, last_hidden_state=True), jdm.mean, jdm.std, device="cpu")
    b = tok.encode_captions({"text": ["walk", "run fast"]})
    assert b["text_emb"].shape == (2, 77, TEXT) and b["text_mask"].sum() == 3
    kept = system.encode_captions({"text": ["x"], "text_emb": np.ones((1, TEXT))})
    assert np.array_equal(kept["text_emb"], np.ones((1, TEXT)))


# ------------------------------------------------------------ presets, CLI

@pytest.mark.parametrize("preset,yaml_name", [("vae_humanml3d", "config_vae_humanml3d.yaml"),
                                              ("mld_humanml3d", "config_mld_humanml3d.yaml"),
                                              ("novae_humanml3d", "config_novae_humanml3d.yaml")])
def test_presets_match_the_yaml(preset, yaml_name):
    """Each field equals what `build_t2m_system` makes of the YAML through
    `load_config`; the train and test settings too. The shipped stage-2
    model runs at guidance 1.0 with 256-wide text (`modules/denoiser.yaml`)."""
    root = os.path.join(os.path.dirname(__file__), "..", "configs")
    cfg = load_config(os.path.join(root, yaml_name))
    _, ref = build_t2m_system(cfg, JDataModule(Config({**cfg, "DEBUG": True})))
    p = T2M_PRESETS[preset]()
    assert PRESETS[preset] is T2M_PRESETS[preset]
    for name in JAX_FIELDS:
        assert getattr(p.model, name) == getattr(ref, name), name
    te = cfg.model.text_encoder.params
    assert p.model.text_encoder_path == (te.modelpath or "")
    assert p.model.last_hidden_state == te.last_hidden_state
    assert p.model.min_len == cfg.DATASET.SAMPLER.MIN_LEN
    t = p.train
    assert (t.stage, t.batch_size, t.end_epoch) == (cfg.TRAIN.STAGE, cfg.TRAIN.BATCH_SIZE,
                                                    cfg.TRAIN.END_EPOCH)
    assert (t.lr, t.step_size, t.gamma) == (float(cfg.TRAIN.OPTIM.LR), cfg.TRAIN.OPTIM.STEP_SIZE,
                                            cfg.TRAIN.OPTIM.GAMMA)
    assert (t.val_every_steps, t.save_checkpoint_epoch) == (cfg.LOGGER.VAL_EVERY_STEPS,
                                                            cfg.LOGGER.SACE_CHECKPOINT_EPOCH)
    assert (t.seed, p.name, p.dataset) == (cfg.SEED_VALUE, cfg.NAME, cfg.DATASET_NAME)
    if cfg.TRAIN.get("PRETRAINED_VAE"):
        assert cfg.TRAIN.PRETRAINED_VAE.split("/")[-3] == "s1_humanml3d"
        assert t.pretrained_vae.endswith("/s1_humanml3d/checkpoints/latest")
    else:
        assert t.pretrained_vae == ""
    q = p.test
    assert (q.batch_size, q.replication_times, q.count_time) == (
        cfg.TEST.BATCH_SIZE, cfg.TEST.REPLICATION_TIMES, cfg.TEST.COUNT_TIME)
    assert (q.mm_num_samples, q.mm_num_repeats, q.mm_num_times) == (
        cfg.TEST.MM_NUM_SAMPLES, cfg.TEST.MM_NUM_REPEATS, cfg.TEST.MM_NUM_TIMES)
    assert not q.mm and q.checkpoint == cfg.TEST.CHECKPOINTS


TINY = ["model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
        f"model.text_encoded_dim={TEXT}", f"model.max_len={T}", "model.min_len=8",
        "train.val_every_steps=1"]


def test_cli_trains_both_stages_and_novae_on_the_cpu(tmp_path):
    """`main(argv)` at a tiny size: stage 1 checkpoints; stage 2 loads that
    VAE, keeps it bitwise, trains the denoiser and validates; a resume
    continues at the saved step; novae trains its diffusion stage and
    refuses a VAE stage; `dataset=kit` takes 251 features."""
    common = ["--device", "cpu", "--batch_size", "64", "--epochs", "1", *TINY]
    s1 = main(["--preset", "vae_humanml3d", "--out", str(tmp_path / "s1"), *common])
    assert s1.step == 4 and s1.checkpoints == [str(tmp_path / "s1" / "checkpoints" / "4.pt")]
    assert set(s1.history[0]["val"]) == {"total", "recons_feature", "recons_joints", "kl_motion"}
    assert all(np.isfinite(s["total"]) for s in s1.history[0]["steps"])
    s2 = main(["--preset", "mld_humanml3d", "--out", str(tmp_path / "s2"),
               "--pretrained_vae", str(tmp_path / "s1" / "checkpoints" / "latest"), *common])
    for k, v in s2.system.vae.state_dict().items():
        assert torch.equal(v, s1.system.vae.state_dict()[k]), k
    assert set(s2.history[0]["val"]) == {"total", "inst_loss"} and s2.step == 4
    again = main(["--preset", "mld_humanml3d", "--out", str(tmp_path / "s2"), "--resume",
                  str(tmp_path / "s2"), *common[:-len(TINY) - 2], "--epochs", "2", *TINY])
    assert again.start_epoch == 1 and again.step == 8
    nv = main(["--preset", "novae_humanml3d", "--out", str(tmp_path / "nv"), *common,
               "model.num_layers=2", "model.num_heads=2"])
    assert nv.system.diffusion_only and not hasattr(nv.system, "vae") and nv.step == 4
    with pytest.raises(ValueError, match="vae stage is undefined"):
        main(["--preset", "novae_humanml3d", "--out", str(tmp_path / "nv1"), *common,
              "train.stage='vae'"])
    kit = main(["--preset", "vae_humanml3d", "--out", str(tmp_path / "kit"), *common,
                "dataset=kit"])
    assert kit.system.cfg.nfeats == 251 and kit.datamodule.njoints == 21


def test_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--preset", "mld_humanml3d", "--out", str(tmp_path)])


# --------------------------------------------------------------------- data

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


def test_datamodule_matches_jax_on_a_written_release(tmp_path):
    """The release's batches (shuffled order and unit-length crops from
    `random.Random(seed)`, the missing and the too-short clips skipped),
    `renorm4t2m` with the evaluator statistics, `feats2joints`, and
    `get_datamodule` choosing the release, also for KIT's 251 features."""
    root = write_release(tmp_path / "HumanML3D")
    jcfg = Config({"DATASET": {"SAMPLER": {"MAX_LEN": 48, "MIN_LEN": 40}}})
    ours, theirs = HumanML3DDataModule(str(root), max_len=48), JDataModule(jcfg, str(root))
    assert not ours.is_synthetic and ours.num_train == theirs.num_train == 6
    for seed in (0, 3):
        same_batches(ours.batches("train", 2, seed=seed, drop_last=False),
                     theirs.batches("train", 2, seed=seed, drop_last=False))
    same_batches(ours.batches("test", 2, shuffle=False), theirs.batches("test", 2, shuffle=False))
    b = next(ours.batches("test", 2, shuffle=False))
    assert b["text"] == ["a person walks number 000001", "a person walks number M000004"]
    np.testing.assert_allclose(ours.renorm4t2m(b["motion"]), theirs.renorm4t2m(b["motion"]),
                               rtol=1e-6)
    joints = ours.feats2joints(torch.as_tensor(b["motion"]))
    close(joints.numpy(), theirs.feats2joints(b["motion"]), MODULE_RTOL)
    with pytest.raises(KeyError):
        ours.split_arrays("train")
    assert not get_datamodule("humanml3d", root=str(tmp_path), motion_length=48).is_synthetic
    kit_root = write_release(tmp_path / "KIT-ML", nfeats=251)
    kit = get_datamodule("kit", root=str(tmp_path), motion_length=48)
    jkit = JDataModule(jcfg, str(kit_root), nfeats=251)
    assert kit.nfeats == 251 and kit.njoints == 21
    same_batches(kit.batches("train", 2, seed=1), jkit.batches("train", 2, seed=1))
    assert get_datamodule("kit", root=str(tmp_path / "absent")).is_synthetic


def test_synthetic_datamodule_matches_jax():
    """The synthetic splits (256 / 64 / 64) with their captions: batches,
    split arrays and batch order as the JAX module's, `renorm4t2m` the raw
    features."""
    jdm = JDataModule(Config({"DATASET": {"SAMPLER": {"MAX_LEN": T, "MIN_LEN": 8}},
                              "model": {"denoiser": {"params": {"text_encoded_dim": TEXT}}}}))
    ours = HumanML3DDataModule(None, max_len=T, min_len=8, text_dim=TEXT)
    assert ours.is_synthetic and ours.num_train == jdm.num_train == 256
    same_batches(ours.batches("train", 8, seed=4), jdm.batches("train", 8, seed=4))
    same_batches(ours.batches("test", 8, shuffle=False, drop_last=False),
                 jdm.batches("test", 8, shuffle=False, drop_last=False))
    arrays, ref = ours.split_arrays("val"), jdm.split_arrays("val")
    assert set(arrays) == set(ref)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], ref[k])
    for a, b in zip(ours.batch_indices("train", 8, seed=2), jdm.batch_indices("train", 8, seed=2)):
        np.testing.assert_array_equal(a, b)
    m = arrays["motion"][:2]
    np.testing.assert_allclose(ours.renorm4t2m(m), jdm.renorm4t2m(m), rtol=1e-6)
    assert [len(ours._sets[s]) for s in ("train", "val", "test")] == [256, 64, 64]
