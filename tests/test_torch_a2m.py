"""The port's action-to-motion model against the JAX package on the CPU:
`EmbedAction`, the rot6d forward kinematics, both losses with the JAX
losses' own draws, one AdamW step of each stage against optax, `sample`
against the composed JAX path, and kernel 5's plain version at the a2m
shape against the flax `Denoiser` under the `ddim_sample` scan.

Weights go from the port's seeded, perturbed system to the JAX tree
through `tools/convert_checkpoint.py::convert_mld_checkpoint` (plus the
action table). The JAX losses split their draws inside
(`seeme_tpu/models/a2m.py:80`, `:98`) and `sample` draws z0 inside
(`:131-133`), so the tests re-derive the losses' draws from the same keys
and hand them to the port, and compose the JAX sampling themselves
(`embed_action` -> `ddim_sample(z_init=...)` -> `vae.decode`). Dropout is 0.
Sizes: latent 1 x 32, 3 layers, 16 frames, 4 DDIM steps, batch 4; the
kernel's plain version at the a2m width (latent 256, ff 128).
Tolerances: exact for the embedding, 1e-5 of max |joints| for FK, 1e-5
relative for loss terms and for every tensor after the AdamW step (float64
on both sides: Adam's first update is about lr * sign(g), which float32
rounding of a gradient near 0 would flip), 1e-4 of max |features| or max
|z| for sampling.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seeme_tpu.core import synthetic_smpl as j_synthetic_smpl
from seeme_tpu.core.rotation2xyz import rot6d_motion_to_joints as j_fk
from seeme_tpu.diffusion.sampling import ddim_sample as j_ddim_sample
from seeme_tpu.diffusion.schedulers import DiffusionSchedule as JSchedule
from seeme_tpu.models.a2m import A2MConfig as JConfig
from seeme_tpu.models.a2m import A2MSystem as JSystem
from seeme_tpu.models.denoiser import Denoiser as JDenoiser
from seeme_tpu.nn.action import EmbedAction as JEmbedAction
from seeme_tpu.train.state import make_optimizer as j_make_optimizer
from seeme_tpu_torch.convert import from_jax_params
from seeme_tpu_torch.core.rotation2xyz import rot6d_motion_to_joints
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.diffusion.schedulers import DiffusionSchedule
from seeme_tpu_torch.models import a2m as a2m_mod
from seeme_tpu_torch.models.a2m import A2MConfig, A2MSystem
from seeme_tpu_torch.models.denoiser import Denoiser
from seeme_tpu_torch.nn.action import EmbedAction
from seeme_tpu_torch.nn.init import init_parameters_, perturb_parameters_
from seeme_tpu_torch.ops import denoiser_fused as dfu
from seeme_tpu_torch.train.loop import train_step
from seeme_tpu_torch.train.state import make_optimizer
from tools.convert_checkpoint import convert_mld_checkpoint

B, W, T, STEPS, CLASSES = 4, 32, 16, 4, 12
FK_RTOL, LOSS_RTOL, STEP_RTOL, SAMPLE_RTOL = 1e-5, 1e-5, 1e-5, 1e-4
SMALL = dict(num_frames=T, num_classes=CLASSES, latent_dim=(1, W), ff_size=16, num_layers=3,
             num_inference_timesteps=STEPS, dropout=0.0, guidance_uncondp=0.25)
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch in this module: the models are tiny, and
    the suite's workers share the machine's cores, where torch's default of
    one thread per core made the CLI cases several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def close(got, want, rtol, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30), err_msg=msg)


def jax_tree(system):
    """The port's weights as the JAX `A2MSystem.init_params` tree."""
    sd = {k: v.detach().numpy().copy() for k, v in system.state_dict().items()}
    tree = convert_mld_checkpoint(sd)
    tree["embed_action"] = {"params": {"action_embedding": sd["embed_action.action_embedding"]}}
    return jax.tree.map(lambda a: jnp.array(a, copy=True), tree)


def build(**kw):
    cfg = A2MConfig(**{**SMALL, **kw})
    system = A2MSystem(cfg, synthetic_smpl(128), device="cpu", seed=1)
    perturb_parameters_(system, torch.Generator().manual_seed(2))
    return system, JSystem(JConfig(**{**SMALL, **kw})), jax_tree(system)


@pytest.fixture(scope="module")
def batch():
    r = np.random.RandomState(0)
    b = {"motion": r.randn(B, T, 150).astype(np.float32) * 0.3,
         "action": r.randint(0, CLASSES, B).astype(np.int32),
         "length": np.array([T, 12, T, 8], np.int32)}
    return b


# ------------------------------------------------------------------ modules

@pytest.mark.parametrize("mode", ["lookup", "force_mask", "drop"])
def test_embed_action_matches_flax(mode):
    """The table lookup, the forced zero token and the JAX module's own
    train-time drop (its bernoulli draw injected), all exact."""
    table = rand(1, CLASSES, W)
    ids = np.array([0, 5, 11, 5])
    ours = EmbedAction(CLASSES, W)
    with torch.no_grad():
        ours.action_embedding.copy_(torch.as_tensor(table))
    ref, params = JEmbedAction(CLASSES, W, 0.5), {"params": {"action_embedding": table}}
    rng = jax.random.PRNGKey(3)
    if mode == "lookup":
        want, got = ref.apply(params, ids), ours(torch.as_tensor(ids))
    elif mode == "force_mask":
        want, got = ref.apply(params, ids, force_mask=True), ours(torch.as_tensor(ids),
                                                                   force_mask=True)
        assert not got.any()
    else:
        drop = np.asarray(jax.random.bernoulli(rng, 0.5, (B, 1)))
        assert drop.any() and not drop.all()
        want = ref.apply(params, ids, train=True, rng=rng)
        got = ours(torch.as_tensor(ids), drop=torch.tensor(drop))
    assert got.shape == (B, 1, W)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("translation,keep_global_orient", [(True, True), (False, True),
                                                            (True, False)])
def test_rot6d_motion_to_joints_matches_jax(translation, keep_global_orient):
    """FK of 150 rot6d features (the trajectory in 144:147, zeros after)
    with and without the trajectory and with the root rotation replaced."""
    feats = rand(4, 2, 5, 150)
    feats[..., 147:] = 0.0
    want = j_fk(j_synthetic_smpl(n_verts=128), jnp.asarray(feats), translation=translation,
                keep_global_orient=keep_global_orient)
    got = rot6d_motion_to_joints(synthetic_smpl(128), torch.as_tensor(feats),
                                 translation=translation, keep_global_orient=keep_global_orient)
    assert got.shape == (2, 5, 24, 3)
    close(got.numpy(), want, FK_RTOL)
    if not translation:
        assert not got[..., 0, :].any()


# -------------------------------------------------------------------- losses

def jax_draws(jsystem, stage, rng):
    """The draws of the JAX `vae_loss` / `diffusion_loss` from `rng`."""
    latent = (B, 1, W)
    if stage == "vae":
        return {"eps": jax.random.normal(jax.random.split(rng)[1], latent)}
    z_rng, a_rng, t_rng, n_rng, _ = jax.random.split(rng, 5)
    return {"eps": jax.random.normal(z_rng, latent),
            "drop": jax.random.bernoulli(a_rng, jsystem.cfg.guidance_uncondp, (B, 1)),
            "noise": jax.random.normal(n_rng, latent),
            "timesteps": jax.random.randint(t_rng, (B,), 0, 1000)}


def torch_draws(draws):
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


@pytest.mark.parametrize("stage", ["vae", "diffusion"])
def test_losses_match_jax(stage, batch):
    """Every term within 1e-5 relative; stage 2's draw drops one sample."""
    system, jsystem, params = build()
    rng = jax.random.PRNGKey(3)
    fn = jsystem.vae_loss if stage == "vae" else jsystem.diffusion_loss
    _, jterms = jax.jit(fn)(params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    draws = torch_draws(jax_draws(jsystem, stage, rng))
    if stage == "diffusion":
        assert draws["drop"].any() and not draws["drop"].all()
    loss_fn = system.vae_loss if stage == "vae" else system.diffusion_loss
    _, terms = loss_fn({k: torch.as_tensor(v) for k, v in batch.items()}, draws=draws)
    assert set(terms) == set(jterms)
    for k, v in terms.items():
        np.testing.assert_allclose(v.item(), float(jterms[k]), rtol=LOSS_RTOL, err_msg=k)


def test_loss_draws_from_a_generator(batch):
    system, _, _ = build()
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    assert set(system.loss_draws("vae", tb, gen)) == {"eps"}
    d = system.loss_draws("diffusion", tb, gen)
    assert d["eps"].shape == d["noise"].shape == (B, 1, W)
    assert d["drop"].shape == (B, 1) and d["drop"].dtype == torch.bool
    assert d["timesteps"].shape == (B,) and int(d["timesteps"].max()) < 1000


@pytest.mark.parametrize("stage", ["vae", "diffusion"])
def test_adamw_step_matches_optax(stage, batch):
    """One step of the stage's AdamW in float64 on both sides (the JAX
    package's `make_optimizer`, frozen subtrees through `set_to_zero`):
    every trained tensor within 1e-5 relative of optax's and changed, every
    other tensor bitwise as it was (stage 2: the VAE frozen)."""
    system, jsystem, params = build()
    rng = jax.random.PRNGKey(11)
    fn = jsystem.vae_loss if stage == "vae" else jsystem.diffusion_loss
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        b64 = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else v.dtype)
               for k, v in batch.items()}
        opt = j_make_optimizer(stage, p64, lr=LR)

        def step(p, b, r):
            (_, terms), grads = jax.value_and_grad(fn, has_aux=True)(p, b, r)
            return terms, optax.apply_updates(p, opt.update(grads, opt.init(p), p)[0])

        jterms, new = jax.jit(step)(p64, b64, rng)
        draws = {k: torch.tensor(np.asarray(v)) for k, v in jax_draws(jsystem, stage, rng).items()}
        want = from_jax_params(jax.tree.map(np.asarray, dict(new)))
    port = copy.deepcopy(system).double()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    optimizer, schedule = make_optimizer(stage, port, lr=LR)
    tb = {k: torch.as_tensor(v).double() if v.dtype == np.float32 else torch.as_tensor(v)
          for k, v in batch.items()}
    terms = train_step(port, stage, optimizer, schedule, 0, tb, draws=draws)
    for k, v in terms.items():
        np.testing.assert_allclose(v, float(jterms[k]), rtol=LOSS_RTOL, err_msg=k)
    trained = ("vae.",) if stage == "vae" else ("denoiser.", "embed_action.")
    got = port.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        if k.startswith(trained):
            w = want[k].double().numpy()
            assert np.abs(v.numpy() - w).max() <= STEP_RTOL * np.abs(w).max(), k
            assert not torch.equal(v, before[k]), k
        else:
            assert torch.equal(v, before[k]), k


# ------------------------------------------------------------------ sampling

SAMPLE_CASES = {"g1": (1.0, 1, "kernel"), "g7.5": (7.5, 1, "kernel"),
                "g7.5-heads2": (7.5, 2, "loop")}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_matches_jax_composition(case, batch, monkeypatch):
    """`sample(z_init=...)` against `embed_action` -> `ddim_sample(z_init=...)`
    -> `vae.decode` in JAX (CFG as [zeros; token]); one head takes kernel
    5's route (its plain version here), two heads the loop."""
    guidance, heads, route = SAMPLE_CASES[case]
    system, jsystem, params = build(guidance_scale=guidance, num_heads=heads)
    routes = {"kernel": 0, "loop": 0}
    for name, key in (("ddim_fused_tok", "kernel"), ("ddim_sample", "loop")):
        fn = getattr(a2m_mod, name)
        monkeypatch.setattr(a2m_mod, name, lambda *a, _f=fn, _k=key, **k: (
            routes.__setitem__(_k, routes[_k] + 1), _f(*a, **k))[1])
    z0 = rand(8, B, 1, W)

    def compose(p, ids, lengths, z):
        cond = jsystem.embed_action.apply(p["embed_action"], ids)
        if guidance > 1.0:
            cond = jnp.concatenate([jnp.zeros_like(cond), cond])
        z = j_ddim_sample(lambda x, t, r: jsystem.denoiser.apply(p["denoiser"], x, t, cond),
                          jsystem.schedule, jax.random.PRNGKey(0), z.shape, STEPS,
                          guidance_scale=guidance, z_init=z)
        return jsystem.vae.apply(p["vae"], z, T, lengths, method=jsystem.vae.decode)

    want = jax.jit(compose)(params, jnp.asarray(batch["action"]), jnp.asarray(batch["length"]),
                            jnp.asarray(z0))
    got = system.sample(torch.as_tensor(batch["action"]), torch.as_tensor(batch["length"]),
                        z_init=torch.as_tensor(z0))
    assert got.shape == (B, T, 150)
    close(got.numpy(), want, SAMPLE_RTOL)
    assert routes == {"kernel": int(route == "kernel"), "loop": int(route == "loop")}


@pytest.mark.parametrize("guidance", [1.0, 7.5])
def test_kernel5_plain_version_at_the_a2m_shape(guidance):
    """`ddim_fused_plain` (the token kernel's plain version) at latent 256,
    ff 128, one action token a row, against the flax `Denoiser` under the
    JAX `ddim_sample` scan: the exact JAX path, not its bf16 kernel."""
    den = Denoiser((1, 256), ff_size=128, num_layers=3, text_encoded_dim=256, md_trans=False,
                   dropout=0.0)
    init_parameters_(den, torch.Generator().manual_seed(4))
    perturb_parameters_(den, torch.Generator().manual_seed(5))
    sd = den.state_dict()
    jparams = convert_mld_checkpoint({f"denoiser.{k}": v.numpy() for k, v in sd.items()})
    jden = JDenoiser(nfeats=150, latent_dim=(1, 256), ff_size=128, num_layers=3, dropout=0.0,
                     text_encoded_dim=256, md_trans=False)
    token = rand(6, B, 1, 256)
    cond = np.concatenate([np.zeros_like(token), token]) if guidance > 1 else token
    z0 = rand(7, B, 1, 256)
    want = jax.jit(lambda p, c, z: j_ddim_sample(
        lambda x, t, r: jden.apply(p, x, t, c), JSchedule(), jax.random.PRNGKey(0), z.shape,
        STEPS, guidance_scale=guidance, z_init=z))(jparams["denoiser"], cond, z0)
    got = dfu.ddim_fused_plain(sd, torch.as_tensor(cond), torch.as_tensor(z0),
                               DiffusionSchedule(), STEPS, 3, guidance, md_trans=False)
    close(got.numpy(), want, SAMPLE_RTOL)


def test_from_jax_params_takes_the_jax_init_tree():
    """The tree `A2MSystem.init_params` builds maps onto every port
    parameter, the action table included, shape for shape (strict load)."""
    system, jsystem, _ = build()
    shapes = jax.eval_shape(jsystem.init_params, jax.random.PRNGKey(5))
    tree = jax.tree.map(lambda s: np.full(s.shape, 0.5, np.float32), shapes)
    system.load_state_dict(from_jax_params(tree), strict=True)
    assert all(bool((p == 0.5).all()) for p in system.parameters())
