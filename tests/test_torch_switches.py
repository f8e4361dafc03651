"""The port's sampling switches against the JAX package on the CPU, in f32:
the DDIM step at eta > 0, with the `sample` prediction and `clip_sample`;
`ddim_sample` at eta > 0, `ddpm_sample` and `ddim_sample_with_trajectory`
with the JAX scans' own draws replayed; `snr` and `ddim_timesteps_static`;
the MD stack's condition mask against the flax `Denoiser`; the ego
system's loop route (eta 0.5, two heads, `use_fused` off) against the JAX
`SeeMeSystem.sample_from_cond`, which takes its scan on the CPU; the text-
and action-to-motion models with `use_fused` off; `TEST.USE_FUSED` in the
test CLI; and the train CLI's `TRAIN.RESUME` and `LOGGER.LOG_EVERY_STEPS`.

Tolerances: 1e-5 of max for the schedule and the samplers over a toy
denoiser, 1e-5 for the masked MD stack, 1e-4 of max |features| for the
systems (as `tests/test_torch_system.py`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.core.smpl import synthetic_smpl as j_synthetic_smpl
from seeme_tpu.diffusion import sampling as j_sampling
from seeme_tpu.diffusion.schedulers import DiffusionSchedule as JSchedule
from seeme_tpu.diffusion.schedulers import ddim_timesteps_static as j_static
from seeme_tpu.diffusion.schedulers import snr as j_snr
from seeme_tpu.models.a2m import A2MConfig as JA2MConfig
from seeme_tpu.models.a2m import A2MSystem as JA2MSystem
from seeme_tpu.models.denoiser import Denoiser as JDenoiser
from seeme_tpu.models.seeme import SeeMeConfig as JConfig
from seeme_tpu.models.seeme import SeeMeSystem as JSystem
from seeme_tpu.models.t2m import T2MConfig as JT2MConfig
from seeme_tpu.models.t2m import T2MSystem as JT2MSystem
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.humanml import SyntheticT2MDataset
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.diffusion import sampling
from seeme_tpu_torch.diffusion.schedulers import DiffusionSchedule, ddim_timesteps_static, snr
from seeme_tpu_torch.models import a2m as a2m_mod
from seeme_tpu_torch.models import seeme as seeme_mod
from seeme_tpu_torch.models import t2m as t2m_mod
from seeme_tpu_torch.models.a2m import A2MConfig, A2MSystem
from seeme_tpu_torch.models.denoiser import Denoiser
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
from seeme_tpu_torch.nn.init import init_parameters_, perturb_parameters_
from seeme_tpu_torch.test.__main__ import Evaluator
from seeme_tpu_torch.test.__main__ import main as eval_main
from seeme_tpu_torch.test.__main__ import parse_args as eval_args
from seeme_tpu_torch.train.__main__ import main as train_main
from tools.convert_checkpoint import convert_mld_checkpoint
from test_torch_a2m import jax_tree, one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
B, W, STEPS, POINTS, D = 3, 32, 5, 64, 8
SMALL = dict(latent_dim=(1, W), ff_size=16, num_layers=3, num_inference_timesteps=STEPS,
             scene_points=POINTS, scene_feat_dim=W)
SCHED_RTOL, SYSTEM_RTOL = 1e-5, 1e-4


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def close(got, want, rtol, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()), err_msg=msg)


def spy(monkeypatch, module, names):
    """Calls of each named function of `module`, recorded by name."""
    calls = []
    for name in names:
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _f=real, _n=name, **k: calls.append(_n) or _f(*a, **k))
    return calls


# ------------------------------------------------------------------ schedule

@pytest.mark.parametrize("prediction,eta,clip", [
    ("epsilon", 0.5, False), ("sample", 0.0, False), ("sample", 0.5, True),
    ("epsilon", 0.0, True), ("epsilon", 1.0, False)])
def test_ddim_step_matches_jax(prediction, eta, clip):
    """One step at the first, middle and last timesteps of a 50-step window,
    the noise injected."""
    ours = DiffusionSchedule(prediction_type=prediction, clip_sample=clip)
    theirs = JSchedule(prediction_type=prediction, clip_sample=clip)
    x, out, noise = rand(1, B, 2, D) * 2, rand(2, B, 2, D) * 2, rand(3, B, 2, D)
    for t in ours.ddim_timesteps(50)[[0, 25, 49]]:
        got = ours.ddim_step(torch.as_tensor(out), int(t), torch.as_tensor(x), 50, eta,
                             torch.as_tensor(noise))
        want = theirs.ddim_step(jnp.asarray(out), int(t), jnp.asarray(x), 50, eta,
                                jnp.asarray(noise))
        close(got.numpy(), want, SCHED_RTOL, f"t={t}")
        x0 = ours.predict_x0(torch.as_tensor(out), int(t), torch.as_tensor(x))
        close(x0.numpy(), theirs.predict_x0(jnp.asarray(out), int(t), jnp.asarray(x)),
              SCHED_RTOL)
        if clip:
            assert float(x0.abs().max()) <= 1.0
    with pytest.raises(ValueError, match="needs noise"):
        ours.ddim_step(torch.as_tensor(out), 1, torch.as_tensor(x), 50, 0.5)


@pytest.mark.parametrize("schedule", ["scaled_linear", "squaredcos_cap_v2"])
def test_snr_and_static_timesteps_match_jax(schedule):
    ours = DiffusionSchedule(beta_schedule=schedule, beta_start=1e-4, beta_end=0.02)
    theirs = JSchedule(beta_schedule=schedule, beta_start=1e-4, beta_end=0.02)
    np.testing.assert_array_equal(ours.alphas_cumprod, np.asarray(theirs.alphas_cumprod))
    t = np.array([0, 1, 500, 998, 999])
    close(snr(ours, torch.as_tensor(t)).numpy(), j_snr(theirs, jnp.asarray(t)), SCHED_RTOL)
    for n in (10, 50):
        ts, count = ddim_timesteps_static(ours, n)
        jts, jcount = j_static(theirs, n)
        assert count == jcount == n
        np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))


# ------------------------------------------------------------------ samplers

W_TOY, C_TOY = rand(4, D, D) * 0.3, rand(5, 2 * B, 1, D) * 0.5


def toy(x, t, lib):
    """A denoiser both frameworks compute alike; each row of a doubled
    batch gets its own offset, so the guidance mix shows."""
    w, c = lib.asarray(W_TOY), lib.asarray(C_TOY[: x.shape[0]])
    return lib.tanh(x @ w + c * (t[:, None, None] / 1000.0))


def torch_toy(x, t):
    return torch.tanh(x @ torch.as_tensor(W_TOY) + torch.as_tensor(C_TOY[: x.shape[0]])
                      * (t[:, None, None].float() / 1000.0))


def replay(key, steps, shape, per_step=3):
    """(the initial draw, every step's noise) of a JAX sampler's scan: one
    split for the initial noise, then `per_step` splits a step, the last the
    step's noise (`seeme_tpu/diffusion/sampling.py:24-100`)."""
    rng, init_rng = jax.random.split(key)
    z0 = np.array(jax.random.normal(init_rng, shape))
    noise = []
    for _ in range(steps):
        rng, *subs = jax.random.split(rng, per_step)
        noise.append(np.array(jax.random.normal(subs[-1], shape)))
    return z0, np.stack(noise) if noise else None


@pytest.mark.parametrize("guidance", [1.0, 2.5])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_matches_jax(eta, guidance):
    key, shape = jax.random.PRNGKey(7), (B, 2, D)
    z0, noise = replay(key, 10, shape)
    want = j_sampling.ddim_sample(lambda x, t, r: toy(x, t, jnp), JSchedule(), key, shape, 10,
                                  eta=eta, guidance_scale=guidance)
    got = sampling.ddim_sample(torch_toy, DiffusionSchedule(), shape, 10, guidance,
                               z_init=torch.as_tensor(z0), eta=eta, noise=torch.as_tensor(noise))
    close(got.numpy(), want, SCHED_RTOL)
    drawn = sampling.ddim_sample(torch_toy, DiffusionSchedule(), shape, 10, guidance, eta=eta,
                                 generator=torch.Generator().manual_seed(0))
    assert drawn.shape == shape and bool(torch.isfinite(drawn).all())


@pytest.mark.parametrize("guidance", [1.0, 2.5])
def test_ddpm_sample_matches_jax(guidance):
    """Every training timestep of a 20-step schedule, noise at each."""
    key, shape = jax.random.PRNGKey(8), (B, 1, D)
    z0, noise = replay(key, 20, shape)
    want = j_sampling.ddpm_sample(lambda x, t, r: toy(x, t, jnp),
                                  JSchedule(num_train_timesteps=20), key, shape,
                                  guidance_scale=guidance)
    got = sampling.ddpm_sample(torch_toy, DiffusionSchedule(num_train_timesteps=20), shape,
                               guidance, z_init=torch.as_tensor(z0),
                               noise=torch.as_tensor(noise))
    close(got.numpy(), want, SCHED_RTOL)


@pytest.mark.parametrize("guidance", [1.0, 2.5])
def test_ddim_trajectory_matches_jax(guidance):
    key, shape = jax.random.PRNGKey(9), (B, 1, D)
    z0, _ = replay(key, 0, shape)
    want, wtraj = j_sampling.ddim_sample_with_trajectory(
        lambda x, t, r: toy(x, t, jnp), JSchedule(), key, shape, 10, guidance_scale=guidance)
    got, traj = sampling.ddim_sample_with_trajectory(
        torch_toy, DiffusionSchedule(), shape, 10, guidance, z_init=torch.as_tensor(z0))
    assert traj.shape == (10, *shape)
    close(traj.numpy(), wtraj, SCHED_RTOL)
    np.testing.assert_array_equal(got.numpy(), traj[-1].numpy())
    close(got.numpy(), want, SCHED_RTOL)


# ------------------------------------------------------------------ the MD stack's mask

@pytest.mark.parametrize("heads", [1, 2])
def test_md_cond_mask_matches_flax(heads):
    """A padded condition token leaves both attentions of every MD layer
    (`seeme_tpu/models/denoiser.py:172-177`); what it holds changes nothing."""
    den = Denoiser((1, W), ff_size=16, num_layers=3, num_heads=heads, text_encoded_dim=W,
                   md_trans=True, dropout=0.0)
    init_parameters_(den, torch.Generator().manual_seed(4))
    perturb_parameters_(den, torch.Generator().manual_seed(5))
    den.requires_grad_(False)
    params = convert_mld_checkpoint({f"denoiser.{k}": v.numpy()
                                     for k, v in den.state_dict().items()})["denoiser"]
    jden = JDenoiser(latent_dim=(1, W), ff_size=16, num_layers=3, num_heads=heads, dropout=0.0,
                     text_encoded_dim=W, md_trans=True)
    x, cond = rand(6, B, 1, W), rand(7, B, 3, W)
    t = np.array([3, 500, 999])
    mask = np.array([[True, True, False], [True, False, False], [True, True, True]])
    want = jden.apply(params, x, t, cond, cond_mask=mask)
    got = den(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(cond),
              torch.as_tensor(mask))
    close(got.numpy(), want, SCHED_RTOL)
    padded = cond.copy()
    padded[~mask] = rand(8, int((~mask).sum()), W) * 100
    again = den(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(padded),
                torch.as_tensor(mask))
    close(again.numpy(), got.numpy(), SCHED_RTOL)
    unmasked = den(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(cond))
    assert float((unmasked - got).abs().max()) > 1e-3 * float(got.abs().max())


# ------------------------------------------------------------------ the systems' loop routes

LOOP_CASES = {"eta0.5": dict(eta=0.5), "heads2": dict(num_heads=2),
              "unfused": dict(use_fused=False)}


@pytest.mark.parametrize("guidance", [1.0, 2.5])
@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_ego_loop_route_matches_jax(case, guidance, monkeypatch):
    """`encode_conditioning`, then the reverse process, then the decode,
    against the JAX `SeeMeSystem` (its scan on the CPU) with its own draws
    replayed: no fused DDIM entry is called."""
    kw = LOOP_CASES[case]
    data = SyntheticEgoDataset(B, 60, scene_points=POINTS, seed=0)
    system = SeeMeSystem(SeeMeConfig(guidance_scale=guidance, **SMALL, **kw), synthetic_smpl(256),
                         data.mean, data.std, device="cpu", seed=1)
    perturb_parameters_(system, torch.Generator().manual_seed(2))
    jsystem = JSystem(JConfig(guidance_scale=guidance, **SMALL, **kw), j_synthetic_smpl(256),
                      data.mean, data.std)
    params = jax.tree.map(jnp.asarray, convert_mld_checkpoint(
        {k: v.numpy() for k, v in system.state_dict().items()}))
    calls = spy(monkeypatch, seeme_mod, ("ddim_fused", "ddim_fused_grid", "ddim_fused_tok"))
    nb = data.batch(0, B)
    cond = system.encode_conditioning(to_torch(nb, "cpu"))
    jcond = jax.jit(jsystem.encode_conditioning)(params, {k: jnp.asarray(v) for k, v in nb.items()})
    close(cond.numpy(), jcond, SYSTEM_RTOL)
    key = jax.random.PRNGKey(11)
    z0, noise = replay(key, STEPS, (B, 1, W))
    want = jax.jit(jsystem.sample_from_cond)(params, jcond, key)
    assert not system.takes_kernel(cond.shape[1])
    got = system.sample_from_cond(cond, z_init=torch.as_tensor(z0),
                                  noise=torch.as_tensor(noise))
    assert calls == [] and got.shape == (B, 60, 75)
    close(got.numpy(), want, SYSTEM_RTOL)


def test_kernel_route_by_condition_tokens():
    """Kernel 3 takes any count of condition tokens (a T = 10 latent's
    interactee gives 10, with the scene 11), where the JAX route's VMEM
    budget stops at 8; the token-concat stack's kernel 5 at most 8."""
    data = SyntheticEgoDataset(B, 60, scene_points=POINTS, seed=0)
    for md_trans, routes in ((True, {2: True, 11: True}), (False, {8: True, 9: False})):
        system = SeeMeSystem(SeeMeConfig(md_trans=md_trans, **SMALL), synthetic_smpl(256),
                             data.mean, data.std, device="cpu")
        assert {n: system.takes_kernel(n) for n in routes} == routes


def test_t2m_use_fused_off_matches_jax(monkeypatch):
    """`T2MSystem.sample` with `use_fused` off runs the loop, against the
    JAX system's scan at guidance 7.5."""
    dm = SyntheticT2MDataset(33, 24, 8, seed=2, text_dim=48)
    small = dict(latent_dim=(1, W), ff_size=16, num_layers=3, text_encoded_dim=48, max_len=24,
                 num_inference_timesteps=STEPS)
    system = T2MSystem(T2MConfig(use_fused=False, **small), dm.mean, dm.std, device="cpu",
                       seed=1)
    perturb_parameters_(system, torch.Generator().manual_seed(2))
    jsystem = JT2MSystem(JT2MConfig(use_fused=False, dropout=0.0, **small))
    params = jax.tree.map(jnp.asarray, convert_mld_checkpoint(
        {k: v.numpy() for k, v in system.state_dict().items()}))
    calls = spy(monkeypatch, t2m_mod, ("ddim_fused_tok", "ddim_sample"))
    batch = dm.batch(0, B)
    z0 = rand(9, B, 1, W)
    got = system.sample(torch.as_tensor(batch["text_emb"]), torch.as_tensor(batch["length"]),
                        z_init=torch.as_tensor(z0))
    want = jax.jit(lambda p, t, n, z: jsystem.sample(p, t, jax.random.PRNGKey(0), lengths=n,
                                                     z_init=z))(
        params, jnp.asarray(batch["text_emb"]), jnp.asarray(batch["length"]), jnp.asarray(z0))
    assert calls == ["ddim_sample"]
    close(got.numpy(), want, SYSTEM_RTOL)


def test_a2m_use_fused_off_matches_jax(monkeypatch):
    """`A2MSystem.sample` with `use_fused` off runs the loop, against the
    JAX system's scan (its initial draw replayed) at guidance 7.5."""
    small = dict(latent_dim=(1, W), ff_size=16, num_layers=3, num_frames=16, dropout=0.0,
                 num_inference_timesteps=STEPS, use_fused=False)
    system = A2MSystem(A2MConfig(**small), synthetic_smpl(128), device="cpu", seed=1)
    perturb_parameters_(system, torch.Generator().manual_seed(2))
    jsystem, params = JA2MSystem(JA2MConfig(**small)), jax_tree(system)
    calls = spy(monkeypatch, a2m_mod, ("ddim_fused_tok", "ddim_sample"))
    ids, lengths = np.array([0, 3, 11], np.int32), np.array([16, 9, 12], np.int32)
    key = jax.random.PRNGKey(12)
    z0, _ = replay(key, 0, (B, 1, W))
    want = jax.jit(lambda p, a, n: jsystem.sample(p, a, key, n))(params, ids, lengths)
    got = system.sample(torch.as_tensor(ids), torch.as_tensor(lengths),
                        z_init=torch.as_tensor(z0))
    assert calls == ["ddim_sample"]
    close(got.numpy(), want, SYSTEM_RTOL)


# ------------------------------------------------------------------ the CLIs

TINY = ["DEBUG=true", "model.latent_dim=[1,32]", "model.ff_size=16", "model.num_layers=3",
        "model.scene_points=64", "model.scene_feat_dim=32",
        "model.scheduler.num_inference_timesteps=3"]


@pytest.mark.parametrize("value,want", [(None, True), ("true", True), ("false", False)])
def test_test_cli_reads_use_fused(value, want, tmp_path):
    """TEST.USE_FUSED sets the model's `use_fused` in every branch; absent,
    the model keeps its own (the kernel), where `test.py` defaults to its
    scan (`ROADMAP.md` §3)."""
    for name in ("mld_egobody", "mld_humanact12"):
        extra = [] if value is None else [f"TEST.USE_FUSED={value}"]
        ev = Evaluator(eval_args(["--cfg", os.path.join(CONFIGS, f"config_{name}.yaml"),
                                  "--device", "cpu", "--out", str(tmp_path / name),
                                  *TINY, *extra]))
        assert ev.system.cfg.use_fused is want, name


def test_test_cli_samples_the_ego_loop_at_eta(tmp_path, monkeypatch):
    """The ego branch at eta 0.5 draws each step's noise from the
    replication's generator: finite metrics, replications that differ, a
    rerun that repeats them, no fused entry called."""
    calls = spy(monkeypatch, seeme_mod, ("ddim_fused", "ddim_fused_grid", "ddim_fused_tok"))
    argv = ["--cfg", os.path.join(CONFIGS, "config_mld_egobody.yaml"), "--device", "cpu",
            "--batch_size", "16", "--replication_times", "2", *TINY, "model.scheduler.eta=0.5"]
    first = eval_main([*argv, "--out", str(tmp_path / "a")])
    reps = first["replications"]
    assert calls == [] and reps[0]["MPJPE"] != reps[1]["MPJPE"]
    assert all(np.isfinite(v) for r in reps for v in r.values())
    assert eval_main([*argv, "--out", str(tmp_path / "b")])["replications"] == reps


TRAIN_ARGS = ["--cfg", os.path.join(CONFIGS, "config_vae_egobody.yaml"), "--device", "cpu",
              "--batch_size", "8"]
TRAIN_TINY = TINY[:4] + ["LOGGER.SACE_CHECKPOINT_EPOCH=1", "LOGGER.VAL_EVERY_STEPS=100"]


def steps_in(exp):
    return sorted(os.listdir(os.path.join(exp, "checkpoints")))


def test_cfg_resume_continues_in_place_and_deletes_nothing(tmp_path):
    """`TRAIN.RESUME=<this run's dir>` (also spelt as its `checkpoints/latest`):
    the run restores the saved step and epoch and keeps every step file;
    the weights equal a run that trained the epochs in one go."""
    exp = str(tmp_path / "exp")
    first = train_main([*TRAIN_ARGS, "--epochs", "1", "--out", exp, *TRAIN_TINY])
    saved = steps_in(exp)
    assert saved == [f"{first.step}.pt"]
    resumed = train_main([*TRAIN_ARGS, "--epochs", "2", "--out", exp, *TRAIN_TINY,
                          f"TRAIN.RESUME={exp}/checkpoints/latest"])
    assert resumed.start_epoch == 1 and resumed.history[0]["epoch"] == 1
    assert resumed.step == 2 * first.step
    assert set(saved) < set(steps_in(exp))
    whole = train_main([*TRAIN_ARGS, "--epochs", "2", "--out", str(tmp_path / "whole"),
                        *TRAIN_TINY])
    for (k, a), b in zip(resumed.system.state_dict().items(), whole.system.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_cfg_resume_mistyped_raises_before_deleting(tmp_path):
    """A TRAIN.RESUME without checkpoints raises FileNotFoundError naming the
    key, and the run's own step files stay; `--resume` wins over the key."""
    exp = str(tmp_path / "exp")
    train_main([*TRAIN_ARGS, "--epochs", "1", "--out", exp, *TRAIN_TINY])
    saved = steps_in(exp)
    with pytest.raises(FileNotFoundError, match="TRAIN.RESUME"):
        train_main([*TRAIN_ARGS, "--epochs", "2", "--out", exp, *TRAIN_TINY,
                    f"TRAIN.RESUME={tmp_path / 'exq'}"])
    assert steps_in(exp) == saved
    again = train_main([*TRAIN_ARGS, "--epochs", "2", "--out", exp, "--resume", exp,
                        *TRAIN_TINY, f"TRAIN.RESUME={tmp_path / 'exq'}"])
    assert again.start_epoch == 1 and set(saved) < set(steps_in(exp))


def test_cfg_warm_start_clears_only_this_runs_steps(tmp_path):
    """A RESUME from another dir restores that dir's step, clears the step
    files an earlier run left in this one, and leaves the source's alone."""
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    first = train_main([*TRAIN_ARGS, "--epochs", "1", "--out", src, *TRAIN_TINY])
    train_main([*TRAIN_ARGS, "--epochs", "3", "--out", dst, *TRAIN_TINY])
    src_steps = steps_in(src)
    warm = train_main([*TRAIN_ARGS, "--epochs", "2", "--out", dst, *TRAIN_TINY,
                       f"TRAIN.RESUME={src}"])
    assert warm.start_epoch == 1 and steps_in(src) == src_steps
    assert steps_in(dst) == [f"{2 * first.step}.pt"]


def test_log_every_steps(tmp_path):
    """LOGGER.LOG_EVERY_STEPS=2 logs epochs 0 and 2 of three (`train.py:389`)."""
    exp = tmp_path / "exp"
    trainer = train_main([*TRAIN_ARGS, "--epochs", "3", "--out", str(exp), *TRAIN_TINY,
                          "LOGGER.LOG_EVERY_STEPS=2"])
    assert trainer.preset.train.log_every_steps == 2 and len(trainer.history) == 3
    log = "".join(open(exp / f).read() for f in os.listdir(exp) if f.endswith(".log")
                  or f == "train_log.txt")
    assert "epoch 0/3" in log and "epoch 2/3" in log and "epoch 1/3" not in log
