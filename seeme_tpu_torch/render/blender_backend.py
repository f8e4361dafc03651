"""Blender (bpy) mesh-render backend (`seeme_tpu/render/blender_backend.py`).

Port of the reference's `mld/render/blender/` package (render.py:31-140,
scene.py:40-96, camera.py:4-52, materials.py:10-135, floor.py:15-52,
tools.py:20-47, meshes.py:17-64) as one module. Only imported when `bpy`
is available (render/mesh.py gates on `blender_available()`); everything
here is host-side DCC code, no device work.

Frame preparation (axis swap, floor removal) happens in `render/mesh.py`
before this module is reached, so the functions here consume z-up vertex
frames directly.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .mesh import GEN_COLOR, GT_COLOR, get_frameidx, sequence_color


# ----------------------------------------------------------------- materials

def _clear_material(material):
    if material.node_tree:
        material.node_tree.links.clear()
        material.node_tree.nodes.clear()


def diffuse_material(r, g, b, a=1.0, roughness=0.127451):
    """Diffuse-BSDF node material (`materials.py:10-23`)."""
    import bpy

    material = bpy.data.materials.new(name="body")
    material.use_nodes = True
    _clear_material(material)
    nodes = material.node_tree.nodes
    links = material.node_tree.links
    output = nodes.new(type="ShaderNodeOutputMaterial")
    diffuse = nodes.new(type="ShaderNodeBsdfDiffuse")
    diffuse.inputs["Color"].default_value = (r, g, b, a)
    diffuse.inputs["Roughness"].default_value = roughness
    links.new(diffuse.outputs["BSDF"], output.inputs["Surface"])
    return material


# --------------------------------------------------------------------- scene

def setup_scene(res: str = "high", denoising: bool = True,
                accelerator: str = "cpu", device: Sequence[int] = (0,)):
    """Lights / camera rig / render engine (`scene.py:40-96`)."""
    import bpy

    scene = bpy.data.scenes["Scene"]
    resolutions = {
        "ultra": (1280 * 2, 1024 * 2),
        "high": (1280, 1024),
        "med": (1280 // 2, 1024 // 2),
        "low": (1280 // 4, 1024 // 4),
    }
    scene.render.resolution_x, scene.render.resolution_y = resolutions[res]
    scene.render.film_transparent = True

    world = bpy.data.worlds["World"]
    world.use_nodes = True
    bg = world.node_tree.nodes["Background"]
    bg.inputs[0].default_value[:3] = (1.0, 1.0, 1.0)
    bg.inputs[1].default_value = 1.0

    if "Cube" in bpy.data.objects:
        bpy.data.objects["Cube"].select_set(True)
        bpy.ops.object.delete()

    bpy.ops.object.light_add(type="SUN", align="WORLD", location=(0, 0, 0))
    bpy.data.objects["Sun"].data.energy = 1.5

    scene.render.engine = "CYCLES"
    if accelerator.lower() == "gpu":
        prefs = bpy.context.preferences.addons["cycles"].preferences
        prefs.compute_device_type = "CUDA"
        bpy.context.scene.cycles.device = "GPU"
        prefs.get_devices()
        for i, d in enumerate(prefs.devices):
            d["use"] = 1 if i in device else 0
    if denoising:
        bpy.context.scene.cycles.use_denoising = True
    bpy.context.scene.cycles.samples = 64
    return scene


def plot_floor(data: np.ndarray):
    """Checker/diffuse ground plane under the motion extent
    (`floor.py:15-52`, big_plane=False as the mesh path uses)."""
    import bpy

    minx, miny, _ = data.min(axis=(0, 1))
    maxx, maxy, _ = data.max(axis=(0, 1))
    location = ((maxx + minx) / 2, (maxy + miny) / 2, 0.0)
    scale = (1.08 * (maxx - minx) / 2, 1.08 * (maxy - miny) / 2, 1)
    bpy.ops.mesh.primitive_plane_add(
        size=2, enter_editmode=False, align="WORLD", location=location)
    bpy.ops.transform.resize(value=scale, orient_type="GLOBAL")
    obj = bpy.data.objects["Plane"]
    obj.name = "SmallPlane"
    obj.data.name = "SmallPlane"
    obj.active_material = diffuse_material(0.2, 0.2, 0.2, 1)


class Camera:
    """Follow camera (`camera.py:4-52`), mesh lens presets."""

    _LENS = {"sequence": 65, "frame": 130, "video": 110}

    def __init__(self, first_root: np.ndarray, mode: str):
        import bpy

        camera = bpy.data.objects["Camera"]
        camera.location.x = 7.36
        camera.location.y = -6.93
        camera.location.z = 5.6
        camera.data.lens = self._LENS[mode]
        camera.location.x += first_root[0]
        camera.location.y += first_root[1]
        self.camera = camera
        self._root = np.asarray(first_root, np.float64)

    def update(self, newroot: np.ndarray):
        delta = np.asarray(newroot, np.float64) - self._root
        self.camera.location.x += delta[0]
        self.camera.location.y += delta[1]
        self._root = np.asarray(newroot, np.float64)


# --------------------------------------------------------------------- tools

class _ndarray_pydata(np.ndarray):
    """from_pydata truthiness workaround (`tools.py:14-17`)."""

    def __bool__(self) -> bool:  # pragma: no cover - trivial
        return len(self) > 0


def load_mesh(vertices: np.ndarray, faces: np.ndarray, name: str, mat):
    import bpy

    mesh = bpy.data.meshes.new(name)
    mesh.from_pydata(vertices, [], faces.view(_ndarray_pydata))
    mesh.validate()
    obj = bpy.data.objects.new(name, mesh)
    bpy.context.scene.collection.objects.link(obj)
    bpy.ops.object.select_all(action="DESELECT")
    obj.select_set(True)
    obj.active_material = mat
    bpy.context.view_layer.objects.active = obj
    bpy.ops.object.shade_smooth()
    bpy.ops.object.select_all(action="DESELECT")
    return name


def delete_objs(names):
    import bpy

    if not isinstance(names, list):
        names = [names]
    bpy.ops.object.select_all(action="DESELECT")
    for obj in bpy.context.scene.objects:
        if any(obj.name.startswith(n) or obj.name.endswith(n) for n in names):
            obj.select_set(True)
    bpy.ops.object.delete()
    bpy.ops.object.select_all(action="DESELECT")


def _render_still(path: str):
    import bpy

    bpy.context.scene.render.filepath = path
    bpy.ops.render.render(use_viewport=True, write_still=True)


# -------------------------------------------------------------------- driver

def render_blender(
    frames: np.ndarray,          # (T, V, 3) prepared vertices (z-up)
    faces: np.ndarray,           # (F, 3)
    out_path: str,
    mode: str = "video",
    gt: bool = False,
    exact_frame: Optional[float] = None,
    num: int = 8,
    res: str = "high",
    init: bool = True,
) -> str:
    """The reference render loop (`blender/render.py:31-140`) for meshes:
    video -> frames folder of PNGs; sequence -> one overlaid PNG;
    frame -> one PNG at `exact_frame`."""
    if init:
        setup_scene(res=res)

    if mode == "video":
        frames_folder = os.path.splitext(out_path)[0] + "_frames"
        os.makedirs(frames_folder, exist_ok=True)
        out = frames_folder
    else:
        out = os.path.splitext(out_path)[0] + ".png"

    if mode == "sequence":
        # prune the mostly-static 20% head/tail (`render.py:16-21,62-65`)
        cut = int(len(frames) * 0.2)
        if cut:
            frames = frames[cut:-cut]

    plot_floor(frames)
    base_mat = diffuse_material(*(GT_COLOR if gt else GEN_COLOR))
    roots = frames.mean(axis=1)
    camera = Camera(first_root=roots[0], mode=mode)
    if mode == "sequence":
        camera.update(frames.mean(axis=(0, 1)))

    idxs = get_frameidx(mode, len(frames), exact_frame, num)
    kept = []
    for index, fi in enumerate(idxs):
        if mode == "sequence":
            mat = diffuse_material(
                *sequence_color(index / max(len(idxs) - 1, 1)))
        else:
            mat = base_mat
            camera.update(roots[fi])
        islast = index == len(idxs) - 1
        objname = load_mesh(frames[fi], faces, f"{index:04d}", mat)
        if mode == "video":
            _render_still(os.path.join(out, f"frame_{index:04d}.png"))
            delete_objs(objname)
        elif mode == "frame":
            _render_still(out)
            delete_objs(objname)
        else:  # sequence: accumulate, render once at the end
            kept.append(objname)
            if islast:
                _render_still(out)
    delete_objs(kept)
    delete_objs(["SmallPlane", "Plane"])
    return out
