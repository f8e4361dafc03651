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

The CLI, the VAE at its own widths and the data are in
`test_torch_t2m_train_cli.py`, the helpers in `torch_t2m_train_common.py`.
"""

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
from seeme_tpu.models.text_encoder import ClipTextEncoder as JTextEncoder
from seeme_tpu.train.state import STAGE_TRAINABLE as J_STAGE_TRAINABLE
from seeme_tpu_torch.config.humanml3d import T2M_PRESETS
from seeme_tpu_torch.config.presets import PRESETS
from seeme_tpu_torch.convert import from_jax_params
from seeme_tpu_torch.models.denoiser import Denoiser
from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
from seeme_tpu_torch.models.text_encoder import ClipTextEncoder
from seeme_tpu_torch.train.state import set_stage
from torch_t2m_train_common import (
    B,
    batch,
    build,
    close,
    DENOISER_CASES,
    GRAD_FLOOR,
    GRAD_RTOL,
    jax_draws,
    JAX_FIELDS,
    jdm,
    LOSS_CASES,
    LOSS_RTOL,
    MODULE_RTOL,
    NTOK,
    rand,
    SAMPLE_CASES,
    SAMPLE_RTOL,
    SMALL,
    T,
    TEXT,
    token_mask,
    W,
)
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("case", list(DENOISER_CASES))
def test_denoiser_matches_flax(case):
    """Every arch from the JAX init tree (`from_jax_params`, strict): the
    token-concat and MD U-skip stacks, the plain decoder with `mem_pos`,
    each over latents or (diffusion-only) over features with the length
    mask, with and without a condition mask (the MD stack takes one too,
    its padded tokens out of both attentions); 2 heads."""
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
        m = token_mask(7)
        want = jax.jit(lambda p, m: jden.apply(p, sample, t, cond, None, cond_mask=m))(params, m)
        got = den(torch.as_tensor(sample), torch.as_tensor(t), torch.as_tensor(cond),
                  cond_mask=torch.as_tensor(m))
        close(got.detach().numpy(), want, MODULE_RTOL)


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


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_routes_match_jax(case, jdm, monkeypatch):
    """`sample(z_init=...)` against the JAX `sample(z_init=...)` (its scan
    on the CPU): the pooled VAE model through the token kernel's plain
    version (at 1, 2 and 4 heads, the multi-head cases with a feed-forward
    wider than the latent), the token mode (a mask doubled under CFG) and
    the diffusion-only model through the loop; the route taken is counted."""
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
    """The token kernel takes up to eight pooled condition tokens at any
    head count; more tokens, or a mask, take the loop."""
    system, _, _ = build(jdm)
    assert system.takes_kernel(8, None) and not system.takes_kernel(9, None)
    assert not system.takes_kernel(1, torch.ones(B, 1, dtype=torch.bool))
    for heads in (2, 4):
        multi = T2MSystem(T2MConfig(**{**SMALL, "num_heads": heads}), jdm.mean, jdm.std,
                          device="cpu")
        assert multi.takes_kernel(8, None) and not multi.takes_kernel(9, None)
    out = system.sample(torch.randn(2, 12, TEXT), generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, T, 263) and torch.isfinite(out).all()


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
    (tmp_path / "clip").mkdir()  # a directory is loaded (tests/test_torch_text_encoder.py)
    with pytest.raises(FileNotFoundError, match="config.json"):
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
