"""The port's host tools against the root scripts, on the CPU.

`segment_egobody` and `preprocess_egobody` write what `tools/segment_egobody.py`
and `tools/preprocess_egobody.py` write on a tiny release made as
`tests/test_preprocess.py` makes one (every array `np.array_equal`, the
crops, the EgoHMR interactee and EgoEgo wearer files included). `tsne`'s
latents are within 1e-5 of the max of `scripts/tsne.py`'s on the same
weights (the port's seeded weights carried to the JAX tree through
`tools/convert_checkpoint.py`), and its PCA projection (scikit-learn hidden
on both sides) within 1e-4 of the max. `flops`: one plain DDIM step
counts exactly the products of `chip_smoke.py`'s bound counts (the MD
stack at T = 1 plus the attention it computes elementwise, at T = 2, the
token stack at T = 1), and each of the six paths is within 5 % of XLA's
`cost_analysis()` in `scripts/flops.py` at one DDIM step (measured:
0.3-2.1 % under; XLA counts elementwise work too).
"""

import importlib.util
import os
import pickle
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from seeme_tpu.models.seeme import SeeMeSystem as JSeeMeSystem
from seeme_tpu_torch.config import build
from seeme_tpu_torch.config.loader import load_config
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
from seeme_tpu_torch.ops import denoiser_fused as dfu
from seeme_tpu_torch.tools import flops, preprocess_egobody, segment_egobody, tsne
from test_preprocess import make_raw_recording
from tools import convert_checkpoint as cc
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent


def root_tool(path, argv):
    spec = importlib.util.spec_from_file_location(f"root_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    with mock.patch.object(sys, "argv", [path.name, *argv]):
        return module.main()


def write_release(root, rng):
    """Two splits of raw recordings with image names, bounding boxes, a
    split csv, predicted interactees, EgoEgo wearers and frames."""
    n_frames = 70
    names = [f"img/frame_{i:05d}.jpg" for i in range(n_frames)]
    for split, seed in (("train", 3), ("test", 4)):
        rec = make_raw_recording(n_frames, seed=seed)
        rec["recording_utils"]["original_imgname"] = names
        rec["recording_utils"]["center"] = rng.rand(n_frames, 2).astype(np.float32) * 60 + 60
        rec["recording_utils"]["scale"] = np.full((n_frames,), 0.4, np.float32)
        (root / "raw" / split).mkdir(parents=True)
        np.save(root / "raw" / split / f"rec_{split}.npy", rec)
    (root / "img").mkdir()
    for name in names:
        Image.fromarray((rng.rand(160, 200, 3) * 255).astype(np.uint8)).save(root / name)
    (root / "data_splits.csv").write_text("train,val,test\nrec_train,,rec_test\nrec_b,rec_c,\n")
    pred = {n: {"smpl_parameters": {"global_orient": rng.randn(1, 3).astype(np.float32),
                                    "body_pose": rng.randn(1, 69).astype(np.float32),
                                    "betas": rng.randn(1, 10).astype(np.float32)}}
            for n in names}
    ego = {n: {"transl": rng.randn(3).astype(np.float32),
               "global_orient": np.eye(3, dtype=np.float32)}
           for i, n in enumerate(names) if i % 4}
    for name, obj in (("interactee.pkl", pred), ("egoego.pkl", ego)):
        with open(root / name, "wb") as f:
            pickle.dump(obj, f)


def test_egobody_tools_write_what_the_root_tools_write(tmp_path):
    for side in ("ours", "ref"):
        write_release(tmp_path / side, np.random.RandomState(0))
    ours = segment_egobody.main(["--release", str(tmp_path / "ours"), "--link-npy"])
    root_tool(ROOT / "tools" / "segment_egobody.py", ["--release", str(tmp_path / "ref"),
                                                      "--link-npy"])
    assert ours == {"train": ["rec_train", "rec_b"], "val": ["rec_c"], "test": ["rec_test"]}
    for split in ("train", "val", "test"):
        assert ((tmp_path / "ours" / f"{split}.txt").read_text()
                == (tmp_path / "ref" / f"{split}.txt").read_text())
    for side, run in (("ours", preprocess_egobody.main),
                      ("ref", lambda a: root_tool(ROOT / "tools" / "preprocess_egobody.py", a))):
        d = tmp_path / side
        run(["--root", str(d), "--interactee-pred", str(d / "interactee.pkl"), "--egoego-pred",
             str(d / "egoego.pkl"), "--images-root", str(d), "--crops-per-window", "2"])
    proc_o, proc_r = tmp_path / "ours" / "processed", tmp_path / "ref" / "processed"
    assert sorted(os.listdir(proc_o)) == sorted(os.listdir(proc_r)) == [
        "mean.npy", "std.npy", "test.npz", "train.npz"]
    for name in ("mean.npy", "std.npy"):
        assert np.array_equal(np.load(proc_o / name), np.load(proc_r / name))
    for name in ("train.npz", "test.npz"):
        a, b = np.load(proc_o / name), np.load(proc_r / name)
        assert sorted(a.files) == sorted(b.files) and "image_crops" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)


def test_missing_pillow_is_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        preprocess_egobody._pil_image()


def test_tsne_matches_the_jax_script(tmp_path, monkeypatch):
    """`config_vae_egobody.yaml` at full width, 32 latents, PCA on both sides."""
    cfg_path = str(ROOT / "configs" / "config_vae_egobody.yaml")
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    z, xy, method = tsne.compute(cfg_path, num=32, device="cpu")
    assert method == "PCA" and z.shape == (32, 256) and xy.shape == (32, 2)

    system = build.build_system(load_config(cfg_path), torch.device("cpu"))[2]
    tree = jax.tree.map(jnp.asarray, cc.convert_mld_checkpoint(
        {k: v.detach().numpy().copy() for k, v in system.state_dict().items()}))
    seen = {"z": []}
    real_jit = jax.jit

    def jit(fn, **kw):  # the script jits only its encode: keep each batch's latents
        compiled = real_jit(fn, **kw)

        def run(*args):
            out = compiled(*args)
            seen["z"].append(np.asarray(out).reshape(len(out), -1))
            return out
        return run

    import matplotlib.pyplot as plt

    real_scatter = plt.scatter

    def scatter(x, y, *args, **kw):
        seen["xy"] = np.stack([np.asarray(x), np.asarray(y)], 1)
        return real_scatter(x, y, *args, **kw)

    with mock.patch.object(JSeeMeSystem, "init_params", lambda self, rng: tree), \
            mock.patch.object(jax, "jit", jit), \
            mock.patch.object(plt, "scatter", scatter):
        root_tool(ROOT / "scripts" / "tsne.py", ["--cfg", cfg_path, "--num", "32", "--cpu",
                                                 "--out", str(tmp_path / "ref.png")])
    ref_z, ref_xy = np.concatenate(seen["z"])[:32], seen["xy"]
    np.testing.assert_allclose(z, ref_z, rtol=0, atol=1e-5 * float(np.abs(ref_z).max()))
    np.testing.assert_allclose(xy, ref_xy, rtol=0, atol=1e-4 * float(np.abs(ref_xy).max()))

    out = tmp_path / "ours.png"
    tsne.main(["--cfg", cfg_path, "--num", "32", "--cpu", "--out", str(out)])
    assert out.stat().st_size > 0


def md_attention(D, layers, rows, n_cond, steps):
    """The T = 1 MD layer's attention (logits and value mix over the 1 +
    n_cond + 1 keys, the cross-attention's over n_cond), which its plain
    version computes elementwise, out of FlopCounterMode's sight."""
    return steps * rows * layers * (4.0 * D * (2 + n_cond) + 4.0 * D * n_cond)


@pytest.mark.parametrize("case", ["md-t1", "md-t2", "md-t1-cfg", "tok-t1", "tok-t1-cfg"])
def test_ddim_step_counts_equal_the_bound_counts(case):
    """One plain DDIM step at full width: FlopCounterMode's products equal
    `chip_smoke.py::ddim_flops` / `tok_flops` exactly."""
    md, tokens, cfg_rows = case.startswith("md"), 2 if "t2" in case else 1, "cfg" in case
    B, n_cond = 3, 2 if case.startswith("md") else 1
    if md:
        cfg = SeeMeConfig(scene_points=16, latent_dim=(tokens, 256))
        data = SyntheticEgoDataset(2, 60, scene_points=16)
        system = SeeMeSystem(cfg, synthetic_smpl(256), data.mean, data.std, device="cpu", seed=0)
        sd, width = system.kernel_operands()[0], 256
    else:
        cfg = T2MConfig()
        system = T2MSystem(cfg, np.zeros(263, np.float32), np.ones(263, np.float32),
                           device="cpu", seed=0)
        sd, width = system.kernel_operands()[0], cfg.text_encoded_dim
    rows = 2 * B if cfg_rows else B
    c = torch.randn(rows, n_cond, width)
    z0 = torch.randn(B, tokens, 256)
    g = 2.5 if cfg_rows else 1.0
    counted = flops.count(lambda: dfu.ddim_fused_plain(sd, c, z0, system.schedule, 1,
                                                       cfg.num_layers, g, md_trans=md))
    if md:
        bound = chip_smoke.ddim_flops(sd, cfg.num_layers, rows, n_cond, 1, tokens)
        if tokens == 1:
            counted += md_attention(256, cfg.num_layers, rows, n_cond, 1)
    else:
        bound = chip_smoke.tok_flops(sd, cfg.num_layers, rows, n_cond, 1)
    assert counted == bound


def test_flops_paths_match_xla_cost_analysis():
    """B = 2, 512 scene points and one DDIM step on both sides (the JAX
    script's config patched to them: XLA counts a loop's body once, so at
    50 steps it counts the reverse process as one step), the port's weights
    in the JAX tree."""
    small = dict(scene_points=512, num_inference_timesteps=1)
    B, cfg = 2, SeeMeConfig(**small)
    data = SyntheticEgoDataset(num_samples=B, motion_length=60, scene_points=cfg.scene_points)
    system = SeeMeSystem(cfg, synthetic_smpl(n_verts=6890), data.mean, data.std, device="cpu",
                         seed=0)
    ours = flops.path_flops(system, to_torch(next(data.batches(B, shuffle=False)), "cpu"))
    tree = jax.tree.map(jnp.asarray, cc.convert_mld_checkpoint(
        {k: v.detach().numpy().copy() for k, v in system.state_dict().items()}))

    import seeme_tpu.models.seeme as jseeme

    spec = importlib.util.spec_from_file_location("root_flops", ROOT / "scripts" / "flops.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    costs, analyze = [], module.analyze
    module.analyze = lambda name, fn, *a: costs.append(analyze(name, fn, *a)["flops"])
    j_config = jseeme.SeeMeConfig
    with mock.patch.object(jseeme, "SeeMeConfig", lambda **k: j_config(**{**small, **k})), \
            mock.patch.object(JSeeMeSystem, "init_params", lambda self, rng: tree), \
            mock.patch.object(sys, "argv", ["flops.py", "--batch_size", str(B), "--cpu"]):
        module.main()
    assert len(costs) == len(ours) == 6
    for (name, n), xla in zip(ours.items(), costs):
        assert abs(n / xla - 1) < 0.05, (name, n, xla)
