"""The port's exporters (`seeme_tpu_torch/tools/export_*.py`, `plys2npy.py`)
against the root scripts (`scripts/export_*.py`, `scripts/plys2npy.py`) on
inputs written here, on the CPU.

OBJ (a plain vertex sequence and a result dict, given faces and the
synthetic body's), BVH, glTF and the PLY reader write byte-equal files.
`export_fbx` without bpy writes the same fallbacks as the root script
(`tests/test_tools.py::test_export_fbx_fallback_paths`): the OBJ sequence of
`--mesh` and the `.glb` of `--joints` byte-equal; the `.glb` of `--poses`
has the same structure and joint tracks within 1e-5 of the max (the SMPL
joints come from torch and from JAX).
"""

import importlib.util
import os
import struct
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from seeme_tpu_torch.tools import export_bvh, export_fbx, export_gltf, export_obj, plys2npy
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent


def root_script(name, argv):
    """Run `scripts/<name>.py`'s main in this process with `argv`."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                      ROOT / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        with mock.patch.object(sys, "argv", [f"{name}.py", *argv]):
            module.main()
    finally:
        sys.path.remove(str(ROOT / "scripts"))


def tree(folder):
    """{relative path: bytes} of every file under `folder`."""
    return {str(p.relative_to(folder)): p.read_bytes()
            for p in sorted(Path(folder).rglob("*")) if p.is_file()}


@pytest.fixture
def inputs(tmp_path):
    rng = np.random.RandomState(0)
    d = tmp_path / "in"
    d.mkdir()
    np.save(d / "mesh.npy", rng.randn(3, 40, 3).astype(np.float32))
    np.save(d / "faces.npy", np.array([[0, 1, 2], [3, 4, 5], [7, 8, 39]]))
    np.save(d / "joints.npy", rng.randn(5, 24, 3).astype(np.float32))
    np.save(d / "joints_flat.npy", rng.randn(4, 72).astype(np.float32))
    np.save(d / "poses.npy", (rng.randn(4, 72) * 0.3).astype(np.float32))
    np.save(d / "transl.npy", rng.randn(4, 3).astype(np.float32))
    np.save(d / "result_dict.npy", {"walk": rng.randn(4, 689, 3).astype(np.float32),
                                    "sit": rng.randn(2, 689, 3).astype(np.float32)},
            allow_pickle=True)
    return d


@pytest.mark.parametrize("case", ["plain-faces", "dict-synthetic"])
def test_obj_equals_the_root_script(inputs, tmp_path, case):
    if case == "plain-faces":
        argv = ["--npy", str(inputs / "mesh.npy"), "--faces", str(inputs / "faces.npy"),
                "--stride", "2"]
    else:  # the synthetic 689-vertex body's faces, 2-frame sequences
        argv = ["--npy", str(inputs / "result_dict.npy"), "--frames-per-seq", "2", "--smpl",
                str(tmp_path / "absent.pkl")]
    with mock.patch("seeme_tpu.config.build.load_smpl_or_synthetic", jax_body_689()), \
            mock.patch("seeme_tpu_torch.config.build.load_smpl_or_synthetic", port_body_689()):
        n = export_obj.main([*argv, "--out", str(tmp_path / "ours")])
        root_script("export_obj", [*argv, "--out", str(tmp_path / "ref")])
    ours, ref = tree(tmp_path / "ours"), tree(tmp_path / "ref")
    assert ours == ref and len(ours) == n == (2 if case == "plain-faces" else 6)


def jax_body_689():
    from seeme_tpu.core.smpl import synthetic_smpl

    return lambda cfg: synthetic_smpl(n_verts=689)


def port_body_689():
    from seeme_tpu_torch.core.smpl import synthetic_smpl

    return lambda cfg: synthetic_smpl(n_verts=689)


def test_bvh_gltf_and_plys_equal_the_root_scripts(inputs, tmp_path):
    for name, module, argv, out in (
            ("export_bvh", export_bvh, ["--joints", str(inputs / "joints.npy"), "--fps", "30"],
             "m.bvh"),
            ("export_gltf", export_gltf, ["--npy", str(inputs / "joints.npy")], "m.glb"),
            ("export_gltf", export_gltf, ["--npy", str(inputs / "joints_flat.npy"),
                                          "--fps", "12"], "f.glb")):
        module.main([*argv, "--out", str(tmp_path / f"ours_{out}")])
        root_script(name, [*argv, "--out", str(tmp_path / f"ref_{out}")])
        assert (tmp_path / f"ours_{out}").read_bytes() == (tmp_path / f"ref_{out}").read_bytes()
    plys = tmp_path / "plys"
    plys.mkdir()
    rng = np.random.RandomState(1)
    for i in range(3):
        v = rng.randn(5, 3).astype(np.float32)
        head = f"ply\nformat {'ascii' if i == 1 else 'binary_little_endian'} 1.0\n" \
               f"element vertex 5\nproperty float x\nproperty float y\nproperty float z\n" \
               "property float nx\nend_header\n"
        body = np.concatenate([v, np.ones((5, 1), np.float32)], 1)
        with open(plys / f"f{i}.ply", "wb") as f:
            f.write(head.encode("ascii"))
            if i == 1:
                f.write("".join(" ".join(f"{x:.6f}" for x in row) + "\n" for row in body).encode())
            else:
                f.write(body.astype("<f4").tobytes())
    plys2npy.main(["--dir", str(plys), "--out", str(tmp_path / "ours.npy")])
    root_script("plys2npy", ["--dir", str(plys), "--out", str(tmp_path / "ref.npy")])
    assert (tmp_path / "ours.npy").read_bytes() == (tmp_path / "ref.npy").read_bytes()
    assert np.load(tmp_path / "ours.npy").shape == (3, 5, 3)


def glb_tracks(path):
    data = Path(path).read_bytes()
    doc = export_gltf.parse_glb(data)
    json_len = struct.unpack_from("<II", data, 12)[0]
    start = 20 + json_len + 8
    tracks = []
    for sampler in doc["animations"][0]["samplers"]:
        view = doc["bufferViews"][doc["accessors"][sampler["output"]]["bufferView"]]
        raw = data[start + view["byteOffset"]:start + view["byteOffset"] + view["byteLength"]]
        tracks.append(np.frombuffer(raw, np.float32).reshape(-1, 3))
    return doc, np.stack(tracks, 1)


def test_fbx_fallbacks_equal_the_root_script(inputs, tmp_path):
    if export_fbx.bpy_available():
        pytest.skip("bpy is installed: the exporter writes .fbx, not the fallbacks")
    mesh = ["--mesh", str(inputs / "mesh.npy"), "--faces", str(inputs / "faces.npy")]
    for side, run in (("ours", export_fbx.main), ("ref", lambda a: root_script("export_fbx", a))):
        run([*mesh, "--out", str(tmp_path / side / "a.fbx")])
        run(["--joints", str(inputs / "joints.npy"), "--out", str(tmp_path / side / "b.fbx")])
    assert tree(tmp_path / "ours") == tree(tmp_path / "ref")
    assert (tmp_path / "ours" / "a_obj" / "frame_0000.obj").exists()
    assert (tmp_path / "ours" / "b.glb").exists()

    poses = ["--poses", str(inputs / "poses.npy"), "--transl", str(inputs / "transl.npy")]
    out = export_fbx.main([*poses, "--cpu", "--out", str(tmp_path / "c.fbx")])
    root_script("export_fbx", [*poses, "--out", str(tmp_path / "ref_c.fbx")])
    assert out == str(tmp_path / "c.glb")
    doc, ours = glb_tracks(tmp_path / "c.glb")
    ref_doc, ref = glb_tracks(tmp_path / "ref_c.glb")
    assert ours.shape == ref.shape == (4, 24, 3)
    assert doc["nodes"][3]["name"] == ref_doc["nodes"][3]["name"]
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * float(np.abs(ref).max()))
    if not torch.cuda.is_available():  # --poses computes on the card by default
        with pytest.raises(RuntimeError, match="CUDA"):
            export_fbx.main([*poses, "--out", str(tmp_path / "d.fbx")])
        assert not os.path.exists(tmp_path / "d.glb")
