"""The port's text-to-motion evaluation against the JAX package on the CPU:
every TM2T / MultiModality function and accumulator on the same numpy
inputs, and the test CLI end to end (`python -m seeme_tpu_torch.test` on
the three HumanML3D presets at a tiny width: d 32, 3 layers, 24 frames, 5
DDIM steps) against the root `test.py`'s `_t2m_eval` on the same weights.

The CLI comparison shares every random draw: the port's `sample` /
`reconstruct` record the noise they draw from their generators, and the JAX
system replays it (`z_init`, or the reparameterization's eps) in the same
order; `test.py`'s own `jax.jit` wrappers are bypassed so that each call
takes the next draw. Both evaluators carry the same weights (the JAX
`T2MEvaluator`'s PRNGKey(0) init, written in the released layout for the
port). Every statistic in `metrics_<stamp>.json` within 1e-4 relative
(1e-6 absolute for the confidence intervals that are zero).
"""

import importlib.util
import json
import logging
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeme_tpu.config.loader import Config
from seeme_tpu.data.humanml import HumanML3DDataModule as JDataModule
from seeme_tpu.eval import t2m_metrics as jm
from seeme_tpu.eval.t2m_evaluator import T2MEvaluator as JEvaluator
from seeme_tpu.models.t2m import T2MConfig as JConfig
from seeme_tpu.models.t2m import T2MSystem as JSystem
from seeme_tpu.models.text_encoder import ClipTextEncoder as JTextEncoder
from seeme_tpu_torch import convert
from seeme_tpu_torch.config.egobody import apply_overrides
from seeme_tpu_torch.config.presets import PRESETS, build
from seeme_tpu_torch.eval import t2m_metrics as tm
from seeme_tpu_torch.models import t2m as t2m_mod
from seeme_tpu_torch.models.t2m import T2MSystem
from seeme_tpu_torch.nn.init import perturb_parameters_
from seeme_tpu_torch.test.__main__ import main
from tools.convert_checkpoint import convert_mld_checkpoint
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ZERO_ATOL = 1e-4, 1e-6
TEXT, T = 48, 24
TINY = ["model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
        f"model.text_encoded_dim={TEXT}", f"model.max_len={T}", "model.min_len=8",
        "model.num_inference_timesteps=5"]


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ----------------------------------------------------------------- functions

def test_metric_functions_match_jax():
    a, b = rand(1, 40, 16), rand(2, 40, 16)
    np.testing.assert_allclose(tm.euclidean_distance_matrix(a, b),
                               jm.euclidean_distance_matrix(a, b), rtol=1e-6)
    order = np.argsort(tm.euclidean_distance_matrix(a, a + 0.3 * b), axis=1)
    np.testing.assert_array_equal(tm.calculate_top_k(order, 3), jm.calculate_top_k(order, 3))
    for x, y in zip(tm.activation_statistics(a), jm.activation_statistics(a)):
        np.testing.assert_array_equal(x, y)
    mu1, c1 = jm.activation_statistics(a.astype(np.float64))
    mu2, c2 = jm.activation_statistics(b.astype(np.float64))
    assert tm.frechet_distance(mu1, c1, mu2, c2) == pytest.approx(
        jm.frechet_distance(mu1, c1, mu2, c2), rel=1e-12)
    assert tm.diversity(a, 30, seed=3) == jm.diversity(a, 30, seed=3)
    reps = rand(4, 10, 6, 16)
    assert tm.multimodality(reps, 5, seed=2) == jm.multimodality(reps, 5, seed=2)


@pytest.mark.parametrize("shuffled", [False, True], ids=["seeded", "given"])
def test_tm2t_and_mm_accumulators_match_jax(shuffled):
    """Two updates of 40 and 30 rows (pools of 32), the seeded or a given
    shuffle: every metric alike; MultiModality over two updates."""
    ours, ref = tm.TM2TMetrics(), jm.TM2TMetrics()
    if shuffled:
        ours.shuffle_idx = ref.shuffle_idx = np.random.RandomState(9).permutation(70)
    for seed, n in ((5, 40), (6, 30)):
        text, gt = rand(seed, n, 12), rand(seed + 10, n, 12)
        for m in (ours, ref):
            m.update(text, gt + 0.5 * rand(seed + 20, n, 12), gt)
    got, want = ours.compute(), ref.compute()
    assert set(got) == set(want) and len(got) == 11
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-12), k
    mm, jmm = tm.MMMetrics(mm_num_times=4), jm.MMMetrics(mm_num_times=4)
    for seed in (7, 8):
        for m in (mm, jmm):
            m.update(rand(seed, 5, 6, 12))
    assert mm.compute() == jmm.compute()


# ------------------------------------------------------------------------ CLI

def root_test_module():
    spec = importlib.util.spec_from_file_location("root_test_cli", ROOT / "test.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def evaluator_file(tmp_path_factory):
    """The JAX evaluator's default (PRNGKey(0)) weights in the released layout."""
    jev = JEvaluator(nfeats=263)
    path = tmp_path_factory.mktemp("evaluator") / "finest.tar"
    torch.save({"text_encoder": convert.t2m_text_state_dict(jev.text_params),
                "movement_encoder": convert.t2m_movement_state_dict(jev.move_params),
                "motion_encoder": convert.t2m_motion_state_dict(jev.motion_params)}, path)
    return str(path)


def recording(monkeypatch, draws):
    """Make the port's `sample` / `reconstruct` record the noise they draw."""
    sample, reconstruct = T2MSystem.sample, T2MSystem.reconstruct

    def rec_sample(self, text_emb, lengths=None, nframes=None, cond_mask=None, z_init=None,
                   generator=None):
        cfg = self.cfg
        shape = ((len(text_emb), nframes or cfg.max_len, cfg.nfeats) if self.diffusion_only
                 else (len(text_emb), *cfg.latent_dim))
        z = torch.randn(shape, generator=generator, device=self.device)
        draws.append(z.numpy().copy())
        return sample(self, text_emb, lengths, nframes, cond_mask, z_init=z)

    def rec_reconstruct(self, batch, generator=None, eps=None):
        e = torch.randn((len(batch["motion"]), *self.cfg.latent_dim), generator=generator)
        draws.append(e.numpy().copy())
        return reconstruct(self, batch, eps=e)

    monkeypatch.setattr(T2MSystem, "sample", rec_sample)
    monkeypatch.setattr(T2MSystem, "reconstruct", rec_reconstruct)


def jax_eval(monkeypatch, tmp_path, preset, state_dict, draws, mm):
    """`test.py::_t2m_eval` on the port's weights, replaying its draws;
    returns the metrics JSON it writes."""
    mod = root_test_module()
    real_jit = jax.jit
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f if getattr(f, "__module__", None)
                        == mod.__name__ else real_jit(f, *a, **k))
    cfg = Config({"SEED_VALUE": 1234,
                  "TEST": {"COUNT_TIME": True, "MM": mm, "MM_NUM_SAMPLES": 16,
                           "MM_NUM_REPEATS": 3, "MM_NUM_TIMES": 10},
                  "DATASET": {"SAMPLER": {"MAX_LEN": T, "MIN_LEN": 8}},
                  "model": {"denoiser": {"params": {"text_encoded_dim": TEXT}}}})
    dm = JDataModule(cfg)
    m = preset.model
    jcfg = JConfig(**{f: getattr(m, f) for f in JConfig.__dataclass_fields__
                      if f != "use_fused"}, use_fused=False)
    jsys = JSystem(jcfg, feats2joints=dm.feats2joints,
                   text_encoder=JTextEncoder(None, latent_dim=TEXT))
    params = jax.tree.map(jnp.asarray, convert_mld_checkpoint(
        {k: v.numpy() for k, v in state_dict.items()}))
    queue = list(draws)
    fast_sample = real_jit(lambda p, t, m_, z: JSystem.sample(
        jsys, p, t, jax.random.PRNGKey(0), cond_mask=m_, z_init=z))

    def fast_recon_impl(p, b, eps):
        mu, logvar = jsys.vae.apply(p["vae"], b["motion"], b["length"], method=jsys.vae.encode)
        z = mu + jnp.exp(0.5 * logvar) * eps
        return jsys.vae.apply(p["vae"], z, jcfg.max_len, b["length"], method=jsys.vae.decode)

    fast_recon = real_jit(fast_recon_impl)
    jsys.sample = lambda p, t, r, cond_mask=None: fast_sample(p, t, cond_mask, queue.pop(0))
    jsys.reconstruct = lambda p, b, r: fast_recon(p, b, queue.pop(0))
    out = tmp_path / "jax"
    out.mkdir()
    mod._t2m_eval(cfg, jsys, jcfg, params, dm, logging.getLogger("jax_t2m_eval"), str(out),
                  preset.train.stage, preset.test.batch_size, preset.test.replication_times)
    assert not queue and (out / "times.txt").exists()
    (path,) = [p for p in os.listdir(out) if p.startswith("metrics_")]
    return json.loads((out / path).read_text())


CLI_CASES = {
    "mld": ("mld_humanml3d", True, []),
    "vae": ("vae_humanml3d", False, []),
    "novae": ("novae_humanml3d", False, ["model.num_layers=2", "model.num_heads=2"]),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_matches_the_jax_t2m_eval(case, tmp_path, monkeypatch, evaluator_file):
    """Two replications over the 64-sequence synthetic test split in
    batches of 32, `--count_time`, and (stage 2) `test.mm=True` at 16 x 3:
    the MR, TM2T and MultiModality statistics equal `_t2m_eval`'s; the pooled
    VAE model samples through the token kernel's route once a batch and a
    repeat, the others never; `times.txt` and `metrics_*.json` written."""
    name, mm, extra = CLI_CASES[case]
    overrides = [*TINY, *extra, "test.mm_num_samples=16", "test.mm_num_repeats=3",
                 f"test.mm={mm}", f"test.evaluator_dir={evaluator_file!r}"]
    preset = apply_overrides(PRESETS[name](), overrides)
    preset = apply_overrides(preset, ["test.batch_size=32", "test.replication_times=2"])
    _, system = build(preset, torch.device("cpu"))
    perturb_parameters_(system, torch.Generator().manual_seed(4))
    ckpt = tmp_path / "weights.pt"
    torch.save({"state_dict": system.state_dict()}, ckpt)

    draws, calls = [], [0]
    recording(monkeypatch, draws)
    kernel = t2m_mod.ddim_fused_tok
    monkeypatch.setattr(t2m_mod, "ddim_fused_tok",
                        lambda *a, **k: (calls.__setitem__(0, calls[0] + 1), kernel(*a, **k))[1])
    result = main(["--preset", name, "--device", "cpu", "--batch_size", "32",
                   "--replication_times", "2", "--count_time", "--checkpoint", str(ckpt),
                   "--out", str(tmp_path / "port"), *overrides])
    out = tmp_path / "port"
    assert (out / "times.txt").read_text().count("\n") == 4
    assert os.path.exists(result["metrics_path"])
    expected_calls = 2 * 2 + (3 if mm else 0) if case == "mld" else 0
    assert calls[0] == expected_calls
    stats = result["stats"]
    keys = {"MPJPE", "PAMPJPE", "ACCEL", "FID", "Diversity", "gt_Diversity", "Matching_score",
            "gt_Matching_score", *(f"{g}R_precision_top_{k}" for g in ("", "gt_") for k in (1, 2, 3))}
    assert set(stats) == keys | ({"MultiModality"} if mm else set())
    assert all(np.isfinite(v["mean"]) for v in stats.values())

    want = jax_eval(monkeypatch, tmp_path, preset, system.state_dict(), draws, mm)
    assert set(want) == set(stats)
    for k, s in want.items():
        for field in ("mean", "min", "max", "conf_interval"):
            assert stats[k][field] == pytest.approx(s[field], rel=RTOL, abs=ZERO_ATOL), (k, field)


def test_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--preset", "mld_humanml3d", "--out", str(tmp_path)])
