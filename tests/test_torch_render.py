"""The port's rendering (`seeme_tpu_torch/render/`) against the JAX
package's and the root scripts', on the CPU.

The numpy helpers (mesh detection, frame preparation, frame selection, the
colour ramp, the weak-perspective and x-rotation matrices) equal
`seeme_tpu.render.*`'s exactly. `python -m seeme_tpu_torch.render` and the
root `render.py` render the same `.npy` files (joints, `--pairs` with a
ground-truth overlay, `--mesh` in `video` and `sequence` modes) into the
same file names, and every decoded frame is within one grey level of the
root script's (both draw with matplotlib on the same inputs, here at 4
frames and 40 dpi). `demo --render` writes the gifs the root `demo.py
--render` writes on the same weights and noise: the same names and frame
counts, frames within the grey-level difference stated in the test (the
sampled joints differ by up to 1e-4 of their max between the packages).
`render_mesh` takes its backends in the order Blender, pyrender,
matplotlib, and without matplotlib the renderers raise an ImportError that
names it.
"""

import importlib.util
import os
import sys
from pathlib import Path
from unittest import mock

import matplotlib
import numpy as np
import pytest
from PIL import Image, ImageSequence

from seeme_tpu.render import joints as j_joints
from seeme_tpu.render import mesh as j_mesh
from seeme_tpu.render import pyrender_backend as j_pyr
from seeme_tpu_torch import demo
from seeme_tpu_torch.render import __main__ as render_cli
from seeme_tpu_torch.render import joints, mesh
from seeme_tpu_torch.render import pyrender_backend as pyr
from test_torch_entry import CONFIGS, EGO, run_jax_demo, same_latent_noise
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def low_dpi():
    with matplotlib.rc_context({"figure.dpi": 40}):
        yield


def frames(path):
    """The decoded RGB frames of a gif or png, int16."""
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB"), np.int16) for f in ImageSequence.Iterator(im)]


def same_images(ours, ref, share=0.0):
    """The frame count; every frame of the same size, and no more than
    `share` of its pixels more than one grey level from the reference's."""
    a, b = frames(ours), frames(ref)
    assert len(a) == len(b), (ours, len(a), len(b))
    for x, y in zip(a, b):
        assert x.shape == y.shape
        off = float((np.abs(x - y).max(-1) > 1).mean())
        assert off <= share, (ours, off)
    return len(a)


def test_numpy_helpers_equal_the_jax_package():
    rng = np.random.RandomState(0)
    data = rng.randn(5, 50, 3)
    for floor in (False, True):
        np.testing.assert_array_equal(mesh.prepare_mesh_frames(data, floor),
                                      j_mesh.prepare_mesh_frames(data, floor))
    for arr in (np.zeros((4, 6890, 3)), np.zeros((4, 24, 3)), np.zeros((4, 2000))):
        assert mesh.mesh_detect(arr) == j_mesh.mesh_detect(arr)
    for args in (("video", 7, None, 99), ("sequence", 10, None, 4), ("frame", 10, 0.3, 0),
                 ("frame", 9, None, 0)):
        assert mesh.get_frameidx(*args) == j_mesh.get_frameidx(*args)
    with pytest.raises(ValueError):
        mesh.get_frameidx("nope", 1, None, 1)
    for frac in (0.0, 0.37, 1.0):
        assert mesh.sequence_color(frac) == j_mesh.sequence_color(frac)
    assert (mesh.GT_COLOR, mesh.GEN_COLOR) == (j_mesh.GT_COLOR, j_mesh.GEN_COLOR)
    assert joints.SMPL_CHAINS == j_joints.SMPL_CHAINS
    np.testing.assert_array_equal(pyr.weak_perspective_matrix((0.75, 0.5), (0.2, 0.1)),
                                  j_pyr.weak_perspective_matrix((0.75, 0.5), (0.2, 0.1)))
    for deg in (180.0, 33.0):
        np.testing.assert_array_equal(pyr.rotation_x(deg), j_pyr.rotation_x(deg))
    assert (pyr.LIGHT_POSITIONS, pyr.DEFAULT_CAM, pyr.DEFAULT_COLOR) == (
        j_pyr.LIGHT_POSITIONS, j_pyr.DEFAULT_CAM, j_pyr.DEFAULT_COLOR)
    assert pyr.pyrender_available() == j_pyr.pyrender_available()
    assert joints.blender_available() == j_joints.blender_available()


def root_render(argv):
    spec = importlib.util.spec_from_file_location("root_render", ROOT / "render.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    with mock.patch.object(sys, "argv", ["render.py", *argv]):
        module.main()


def write_inputs(folder):
    rng = np.random.RandomState(0)
    folder.mkdir()
    for i in range(2):
        np.save(folder / f"pred_{i}.npy", np.cumsum(rng.randn(4, 24, 3) * 0.05, 0)
                .astype(np.float32))
    np.save(folder / "gt_0.npy", rng.randn(4, 24, 3).astype(np.float32) * 0.2)
    V = 30
    np.save(folder / "verts.npy", (rng.randn(4, V, 3) * 0.2).astype(np.float32))
    np.save(folder / "faces.npy", np.stack([np.arange(V - 2), np.arange(1, V - 1),
                                            np.arange(2, V)], 1))


CASES = {
    "joints": lambda d: ["--npy", str(d / "pred_1.npy"), "--fps", "5"],
    "pairs": lambda d: ["--dir", str(d), "--pairs"],
    "mesh-video": lambda d: ["--npy", str(d / "verts.npy"), "--mesh", "--faces",
                             str(d / "faces.npy")],
    "mesh-sequence": lambda d: ["--npy", str(d / "verts.npy"), "--mesh", "--faces",
                                str(d / "faces.npy"), "--mode", "sequence", "--gt"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_renders_what_render_py_renders(tmp_path, case):
    write_inputs(tmp_path / "in")
    argv = CASES[case](tmp_path / "in")
    written = render_cli.main([*argv, "--out", str(tmp_path / "ours")])
    root_render([*argv, "--out", str(tmp_path / "ref")])
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "ours")) == names
    assert sorted(os.path.basename(p) for p in written) == names
    assert names == {"joints": ["pred_1.gif"], "pairs": ["pred_0.gif", "pred_1.gif"],
                     "mesh-video": ["verts.gif"], "mesh-sequence": ["verts.png"]}[case]
    for name in names:
        n = same_images(tmp_path / "ours" / name, tmp_path / "ref" / name)
        assert n == (1 if name.endswith(".png") else 4)


def test_render_cli_takes_the_render_block(tmp_path):
    """`--cfg` supplies NPY, MODE, FPS and VID_EXT from its RENDER block."""
    write_inputs(tmp_path / "in")
    cfg = tmp_path / "render.yaml"
    cfg.write_text(f'RENDER:\n  NPY: "{tmp_path / "in" / "pred_0.npy"}"\n  FPS: 7\n'
                   '  VID_EXT: "gif"\n  MODE: "video"\n')
    assert render_cli.main(["--cfg", str(cfg), "--out", str(tmp_path / "o")]) == [
        str(tmp_path / "o" / "pred_0.gif")]
    with pytest.raises(SystemExit):
        render_cli.main(["--out", str(tmp_path / "o")])  # neither --npy nor --dir


def test_render_mesh_backend_order(tmp_path, monkeypatch):
    """Blender when bpy imports, else pyrender for videos, else matplotlib."""
    import seeme_tpu_torch.render.blender_backend as blender
    calls = []
    monkeypatch.setattr(blender, "render_blender", lambda *a, **k: calls.append("blender") or "b")
    monkeypatch.setattr(pyr, "render_mesh_video_pyrender",
                        lambda *a, **k: calls.append("pyrender") or "p")
    verts, faces = np.random.RandomState(0).randn(2, 30, 3), np.array([[0, 1, 2]])
    out = str(tmp_path / "v.gif")
    monkeypatch.setattr(joints, "blender_available", lambda: True)
    monkeypatch.setattr(pyr, "pyrender_available", lambda: True)
    assert mesh.render_mesh(verts, faces, out) == "b"
    monkeypatch.setattr(joints, "blender_available", lambda: False)
    assert mesh.render_mesh(verts, faces, out) == "p"
    monkeypatch.setattr(pyr, "pyrender_available", lambda: False)
    assert mesh.render_mesh(verts, faces, out, fps=4) == out
    assert calls == ["blender", "pyrender"]


def test_missing_matplotlib_is_named(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        joints.render_joints_video(np.zeros((2, 24, 3)), str(tmp_path / "a.gif"))
    with pytest.raises(ImportError, match="matplotlib"):
        mesh.render_mesh(np.zeros((2, 30, 3)), np.array([[0, 1, 2]]), str(tmp_path / "m.gif"))


# a sampled joint differs from the JAX demo's by up to 1e-4 of the max
# (tests/test_torch_entry.py), which moves a few antialiased edge pixels,
# and the gif writer picks each frame's palette from the frame, so a moved
# pixel can remap a colour (0.2 % of one frame's pixels measured)
DEMO_SHARE = 1e-2


def test_demo_render_writes_what_demo_py_writes(tmp_path):
    """`config_mld_egobody.yaml --render` at 4 frames: the ego samples drawn
    over their ground truth, as `demo.py:285-293`."""
    argv = ["--cfg", str(CONFIGS / "config_mld_egobody.yaml"), "--render", "--num_samples", "2"]
    overrides = [*EGO, "MOTION_LENGTH=4"]
    with same_latent_noise((2, 32)):
        demo.main([*argv, "--cpu", "--out", str(tmp_path / "ours"), *overrides])
        run_jax_demo("_demo_ego", argv, overrides, tmp_path / "ref")
    gifs = sorted(n for n in os.listdir(tmp_path / "ref") if n.endswith(".gif"))
    assert gifs == ["sample_0.gif", "sample_1.gif"]
    assert sorted(n for n in os.listdir(tmp_path / "ours") if n.endswith(".gif")) == gifs
    for name in gifs:
        assert same_images(tmp_path / "ours" / name, tmp_path / "ref" / name, DEMO_SHARE) == 4


def test_demo_render_of_text_samples(tmp_path):
    """A text config's samples each get a gif beside their `.npy`
    (`demo.py:72-81`)."""
    cap = tmp_path / "caps.txt"
    cap.write_text("4 a person walks\n5 a person jumps\n")
    out = tmp_path / "t"
    saved = demo.main(["--cfg", str(CONFIGS / "config_mld_humanml3d.yaml"), "--example",
                       str(cap), "--render", "--cpu", "--out", str(out), "model.ff_size=16",
                       "model.num_layers=3", "model.scheduler.num_inference_timesteps=2"])
    for p, n in zip(saved, (4, 5)):
        assert len(frames(p.replace(".npy", ".gif"))) == n
