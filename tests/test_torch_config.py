"""The port's config loader, builder and registry (`seeme_tpu_torch/config/`)
against the JAX package's (`seeme_tpu/config/`) and pyyaml, on the CPU.

The port parses the shipped YAML itself (the card's machine has no pyyaml):
every file under `configs/` must read as `yaml.safe_load` reads it, the
cascade with dotted overrides as `seeme_tpu.config.load_config` merges it,
and each experiment YAML must build, field by field, what the JAX builders
build from it and the same `Preset` as the port's preset of that name. The
pose prior of the fitting CLI is held to the JAX one here too.
"""

import dataclasses
import glob
import os
import pickle
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from seeme_tpu.config import build as j_build
from seeme_tpu.config.loader import load_config as j_load_config
from seeme_tpu.config.loader import parse_dotted_overrides as j_overrides
from seeme_tpu.core.pose_prior import MaxMixturePrior as JPrior
from seeme_tpu_torch.config import build, loader, registry
from seeme_tpu_torch.config.presets import PRESETS, from_cli
from seeme_tpu_torch.core.smpl import save_smpl, synthetic_smpl
from seeme_tpu_torch.core.pose_prior import MaxMixturePrior

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = os.path.join(ROOT, "configs")
YAML_FILES = sorted(os.path.relpath(p, CONFIGS)
                    for p in glob.glob(os.path.join(CONFIGS, "**", "*.yaml"), recursive=True))
NAMES = sorted(PRESETS)  # each has configs/config_<name>.yaml
OVERRIDES = ["model.latent_dim=[2,256]", "TRAIN.BATCH_SIZE=8", "TEST.MEAN=true",
             "model.guidance_scale=2.5", "LOSS.LAMBDA_KL=1.0e-3", "TRAIN.OPTIM.LR=3e-4",
             "model.condition=['interactee']", "NAME=renamed"]


def same(a, b):
    """Equal values of equal types, dict keys in the same order."""
    if type(a) is not type(b) and not (isinstance(a, dict) and isinstance(b, dict)):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name", YAML_FILES)
def test_parser_reads_every_shipped_file_as_pyyaml(name):
    path = os.path.join(CONFIGS, name)
    with open(path) as f:
        text = f.read()
    assert same(loader.parse_yaml(text, path), yaml.safe_load(text) or {})


@pytest.mark.parametrize("raw", ["[2,256]", "[1, 256]", "['interactee', 'scene']", "[]", "true",
                                 "False", "off", "null", "~", "", "1e-4", "1.0e-4", "0.00085",
                                 "-3", "+7", "1_000", ".5", "'no'", '"a \\"b\\""', "'it''s'",
                                 "(1, 32)", "./experiments/mld/s1/checkpoints/latest", "gelu",
                                 "${model.latent_dim}", "[[1, 2], 'a b', 3.0]"])
def test_values_read_as_pyyaml(raw):
    assert same(loader.parse_value(raw), yaml.safe_load(raw))


@pytest.mark.parametrize("text,match", [
    ("a:\n  - 1\n  - 2\n", "block sequence"),
    ("a: {b: 1}\n", "flow mapping"),
    ("a: |\n  text\n", "value"),
    ("a: &x 1\nb: *x\n", "value"),
    ("a: !!str 1\n", "value"),
    ("a: 1\na: 2\n", "duplicate key"),
    ("a:\n  b: 1\n   c: 2\n", "indentation"),
    ("a:\n\tb: 1\n", "tab"),
    ("---\na: 1\n", "document"),
    ("a: 0x1f\n", "numeric form"),
    ("a: [1, 2\n", "unterminated"),
    ("a: 'x\n", "unterminated"),
    ("just text\n", "not 'key: value'"),
])
def test_parser_raises_outside_its_subset(text, match):
    with pytest.raises(ValueError, match=match):
        loader.parse_yaml(text, "snippet.yaml")


@pytest.mark.parametrize("name", NAMES)
def test_load_config_with_overrides_matches_jax(name):
    """The cascade (base, the file, the module YAMLs, the assets, then the
    overrides) and the interpolation, tree for tree."""
    path = os.path.join(CONFIGS, f"config_{name}.yaml")
    assets = os.path.join(CONFIGS, "assets.yaml")
    ours = loader.load_config(path, assets, overrides=loader.parse_dotted_overrides(OVERRIDES))
    ref = j_load_config(path, assets, overrides=j_overrides(OVERRIDES))
    assert same(ours, ref)
    assert ours.model.latent_dim == [2, 256] and ours.select("model.denoiser.params.latent_dim") == [2, 256]


def jax_config(cfg):
    """What the JAX builder makes of a loaded config (a stand-in datamodule
    gives the data's width and classes, as the real one would)."""
    name = cfg.DATASET_NAME
    if name in ("humanml3d", "kit"):
        return j_build.build_t2m_system(cfg, types.SimpleNamespace(nfeats=263))[1]
    if name in ("humanact12", "uestc"):
        dm = types.SimpleNamespace(nfeats=150, num_classes=40 if name == "uestc" else 12)
        return j_build.build_a2m_system(cfg, dm)[1]
    return j_build.seeme_config_from_yaml(cfg)


@pytest.mark.parametrize("name", NAMES)
def test_each_yaml_builds_the_jax_config_and_its_preset(name):
    """Every field the port's config shares with the JAX builder's equals
    it, at the shipped values and with `latent_dim [2, 256]`; the whole
    `Preset` equals the port's preset of the same name."""
    path = os.path.join(CONFIGS, f"config_{name}.yaml")
    for overrides in ([], ["model.latent_dim=[2,256]"]):
        cfg = loader.load_config(path, overrides=loader.parse_dotted_overrides(overrides))
        ref = jax_config(j_load_config(path, overrides=j_overrides(overrides)))
        preset = build.preset_from_yaml(cfg)
        model = preset.model
        if name.endswith(("humanact12", "uestc")):
            model = dataclasses.replace(model, num_classes=ref.num_classes)
        shared = {f.name for f in dataclasses.fields(model)} & {f.name for f in dataclasses.fields(ref)}
        assert shared >= {"latent_dim", "num_layers", "guidance_scale", "num_inference_timesteps"}
        for f in sorted(shared):
            want = getattr(ref, f)
            want = dataclasses.asdict(want) if f == "loss" else want
            got = dataclasses.asdict(model.loss) if f == "loss" else getattr(model, f)
            assert got == want, f
        assert model.latent_dim == ((2, 256) if overrides else (1, 256 if "novae" not in name
                                                                 else 512))
    assert build.preset_from_yaml(loader.load_config(path)) == PRESETS[name]()


TINY_EGO = ["model.latent_dim=[1,32]", "model.ff_size=16", "model.num_layers=3",
            "model.scene_points=64", "model.scene_feat_dim=32",
            "model.scheduler.num_inference_timesteps=3"]


@pytest.mark.parametrize("override,field,value", [
    ("model.num_head=2", "num_heads", 2),
    ("model.scheduler.eta=0.5", "eta", 0.5),
    ("model.use_fused=false", "use_fused", False),
])
def test_builder_raises_on_what_the_port_cannot_run(override, field, value, monkeypatch):
    """The three values the port refused before it had a loop route now
    build as the JAX builder builds them, and the system samples through
    the `ddim_sample` loop: no fused DDIM entry is called and no kernel
    launch is counted, where the shipped value calls the MD entry once."""
    from seeme_tpu_torch.models import seeme as seeme_mod
    from seeme_tpu_torch.ops import denoiser_fused as dfu

    calls = []
    for name in ("ddim_fused", "ddim_fused_grid", "ddim_fused_tok"):
        real = getattr(seeme_mod, name)
        monkeypatch.setattr(seeme_mod, name,
                            lambda *a, _real=real, _n=name, **k: calls.append(_n) or _real(*a, **k))

    def sample(overrides):
        cfg = loader.load_config(os.path.join(CONFIGS, "config_mld_egobody.yaml"),
                                 overrides=loader.parse_dotted_overrides(TINY_EGO + overrides))
        preset, dm, system = build.build_system(cfg, torch.device("cpu"))
        batch = {k: torch.as_tensor(v) for k, v in next(dm.batches("test", 2)).items()}
        launches = [f.launches for f in (dfu.ddim_fused, dfu.ddim_fused_grid, dfu.ddim_fused_tok)]
        feats = system.sample_from_cond(system.encode_conditioning(batch),
                                        generator=torch.Generator().manual_seed(0))
        after = [f.launches for f in (dfu.ddim_fused, dfu.ddim_fused_grid, dfu.ddim_fused_tok)]
        assert after == launches
        assert feats.shape == (2, 60, preset.model.nfeats) and bool(torch.isfinite(feats).all())
        return preset, system

    preset, system = sample([override])
    assert getattr(preset.model, field) == value
    assert getattr(j_build.seeme_config_from_yaml(j_load_config(
        os.path.join(CONFIGS, "config_mld_egobody.yaml"), overrides=j_overrides([override]))),
        field) == value
    assert not system.takes_kernel(2) and calls == []
    sample([])
    assert calls == ["ddim_fused"]


def test_smpl_file_is_not_read(tmp_path):
    """Without the SMPL file the synthetic body runs, as in the JAX builder;
    a configured file that exists is read (its body, not the synthetic one)."""
    cfg = loader.load_config(os.path.join(CONFIGS, "config_mld_egobody.yaml"))
    assert build.load_smpl_or_synthetic(cfg).v_template.shape == (6890, 3)
    pkl = tmp_path / "SMPL_NEUTRAL.pkl"
    body = synthetic_smpl(n_verts=256, seed=5)
    save_smpl(body, str(pkl))
    cfg = loader.load_config(os.path.join(CONFIGS, "config_mld_egobody.yaml"),
                             overrides={"model": {"smpl_path": str(pkl)}})
    assert torch.equal(build.load_smpl_or_synthetic(cfg).v_template, body.v_template)


def test_cli_takes_cfg_or_preset():
    """`from_cli` (both CLIs' parser): `--cfg` with YAML overrides and
    `--preset` with its own give the same preset; one of the two is needed."""
    path = os.path.join(CONFIGS, "config_mld_humanml3d.yaml")
    by_cfg = from_cli(None, path, None, ["model.latent_dim=[2,256]", "TRAIN.BATCH_SIZE=8"])
    by_preset = from_cli("mld_humanml3d", None, None,
                         ["model.latent_dim=(2, 256)", "train.batch_size=8"])
    assert by_cfg == by_preset
    with pytest.raises(ValueError, match="--preset or by --cfg"):
        from_cli("mld_humanml3d", path)
    with pytest.raises(FileNotFoundError):
        from_cli(None, os.path.join(CONFIGS, "config_absent.yaml"))


def test_registry_resolves_the_module_targets():
    """Every target of the module YAMLs resolves to the port's class; the
    scheduler and the VAE build from their YAML nodes, naming the reference's
    extra keyword arguments they drop; an unknown target raises with the
    registered ones."""
    cfg = loader.load_config(os.path.join(CONFIGS, "config_mld_humanml3d.yaml"))
    for node in ("denoiser", "motion_vae", "scheduler", "noise_scheduler", "text_encoder",
                 "t2m_textencoder", "t2m_moveencoder", "t2m_motionencoder"):
        assert registry.get_component(cfg.model[node].target)
    sched, _ = registry.instantiate_from_config(cfg.model.scheduler)
    assert sched.num_train_timesteps == 1000
    vae, dropped = registry.instantiate_from_config(cfg.model.motion_vae, nfeats=263)
    assert isinstance(vae, torch.nn.Module) and set(dropped) == {"normalize_before"}
    with pytest.raises(KeyError, match="registered"):
        registry.get_component("mld.models.Unknown")


@pytest.mark.parametrize("gmm", ["fallback", "dict"])
def test_pose_prior_matches_jax(gmm, tmp_path):
    """The max-mixture negative log likelihood of the fallback and of a
    three-component GMM file, against the JAX prior."""
    path = None
    if gmm == "dict":
        r = np.random.RandomState(0)
        a = r.randn(3, 69, 69) * 0.1
        path = str(tmp_path / "gmm_08.pkl")
        with open(path, "wb") as f:
            pickle.dump({"means": r.randn(3, 69) * 0.2,
                         "covars": a @ a.transpose(0, 2, 1) + np.eye(69) * 0.5,
                         "weights": np.array([0.5, 0.3, 0.2])}, f)
    pose = np.random.RandomState(1).randn(5, 69).astype(np.float32) * 0.3
    ours, ref = MaxMixturePrior(path), JPrior(path)
    assert ours.is_fallback == ref.is_fallback == (gmm == "fallback")
    np.testing.assert_allclose(ours(torch.as_tensor(pose)).numpy(),
                               np.asarray(ref(jnp.asarray(pose))), rtol=1e-5)
