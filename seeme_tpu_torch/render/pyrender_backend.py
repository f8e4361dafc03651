"""Offscreen pyrender mesh backend — the reference's mid-quality tier
(`seeme_tpu/render/pyrender_backend.py`).

Ports the role of `mld/render/renderer.py:1-179` (VIBE-style offscreen
renderer: weak-perspective camera, three point lights, metallic-roughness
material, RGBA pass composited over the background) and the per-sequence
driver `mld/render/rendermotion.py:18-75` (first-frame centering, the
`cams=(0.75, 0.75, 0, 0.10)` default, Rx(180°) mesh flip). Sits between the
matplotlib fallback and the Blender backend in `mesh.py::render_mesh`; used
automatically when `pyrender` and `trimesh` import on a host without bpy;
it writes the video with `imageio`.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np

# reference light rig (`renderer.py:70-82`): three point lights around the cam
LIGHT_POSITIONS = ((0.0, -1.0, 1.0), (0.0, 1.0, 1.0), (1.0, 1.0, 2.0))
DEFAULT_CAM = (0.75, 0.75, 0.0, 0.10)       # sx, sy, tx, ty (`rendermotion.py:25`)
DEFAULT_COLOR = (0.11, 0.53, 0.8)           # `rendermotion.py:26`
GT_COLOR = (0.035, 0.415, 0.122)


def weak_perspective_matrix(scale: Sequence[float],
                            translation: Sequence[float]) -> np.ndarray:
    """WeakPerspectiveCamera.get_projection_matrix (`renderer.py:40-48`)."""
    P = np.eye(4)
    P[0, 0] = scale[0]
    P[1, 1] = scale[1]
    P[0, 3] = translation[0] * scale[0]
    P[1, 3] = -translation[1] * scale[1]
    P[2, 2] = -1
    return P


def rotation_x(deg: float) -> np.ndarray:
    """Homogeneous Rx; the reference flips meshes 180° about x
    (`renderer.py:111-113`)."""
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    R = np.eye(4)
    R[1, 1], R[1, 2] = c, -s
    R[2, 1], R[2, 2] = s, c
    return R


def pyrender_available() -> bool:
    """True when pyrender + trimesh import (headless GL picked via
    PYOPENGL_PLATFORM=egl/osmesa, the commented recipe at
    `renderer.py:16-18`)."""
    os.environ.setdefault("PYOPENGL_PLATFORM", "egl")
    try:
        import pyrender  # noqa: F401
        import trimesh  # noqa: F401

        return True
    except Exception:
        if os.environ.get("PYOPENGL_PLATFORM") == "egl":
            os.environ["PYOPENGL_PLATFORM"] = "osmesa"
            try:
                import pyrender  # noqa: F401
                import trimesh  # noqa: F401

                return True
            except Exception:
                return False
        return False


class PyRenderer:
    """`renderer.py:51-171` Renderer: persistent scene + per-frame mesh."""

    def __init__(self, resolution: Tuple[int, int] = (480, 480),
                 bg_color=(1.0, 1.0, 1.0, 0.5),
                 cam_pose: Optional[np.ndarray] = None):
        import pyrender

        self._pyrender = pyrender
        self.resolution = resolution
        self.cam_pose = np.eye(4) if cam_pose is None else np.asarray(cam_pose)
        self.renderer = pyrender.OffscreenRenderer(
            viewport_width=resolution[0], viewport_height=resolution[1],
            point_size=0.5,
        )
        self.scene = pyrender.Scene(bg_color=list(bg_color),
                                    ambient_light=(0.4, 0.4, 0.4))
        light = pyrender.PointLight(color=[1.0, 1.0, 1.0], intensity=4)
        for pos in LIGHT_POSITIONS:
            pose = np.eye(4)
            pose[:3, 3] = pos
            self.scene.add(light, pose=(self.cam_pose @ pose).copy())

    def render(self, verts: np.ndarray, faces: np.ndarray,
               cam: Sequence[float] = DEFAULT_CAM,
               color: Sequence[float] = DEFAULT_COLOR,
               background: Optional[np.ndarray] = None) -> np.ndarray:
        import trimesh

        pyrender = self._pyrender
        mesh = trimesh.Trimesh(vertices=verts, faces=faces, process=False)
        mesh.apply_transform(rotation_x(180.0))

        sx, sy, tx, ty = cam

        class _WeakCam(pyrender.Camera):
            def __init__(self):
                super().__init__(znear=pyrender.camera.DEFAULT_Z_NEAR,
                                 zfar=100000.0)

            def get_projection_matrix(self, width=None, height=None):
                return weak_perspective_matrix((sx, sy), (tx, ty))

        material = pyrender.MetallicRoughnessMaterial(
            metallicFactor=0.0, alphaMode="OPAQUE",
            baseColorFactor=(color[0], color[1], color[2], 1.0),
        )
        mesh_node = self.scene.add(
            pyrender.Mesh.from_trimesh(mesh, material=material), "mesh")
        cam_node = self.scene.add(_WeakCam(), pose=self.cam_pose)
        flags = pyrender.constants.RenderFlags.RGBA
        rgb, _ = self.renderer.render(self.scene, flags=flags)
        self.scene.remove_node(mesh_node)
        self.scene.remove_node(cam_node)

        if background is None:
            background = np.full(
                (self.resolution[1], self.resolution[0], 3), 255, np.uint8)
        if rgb.shape[-1] == 4:
            valid = (rgb[:, :, 3:] > 128)
            out = rgb[:, :, :3] * valid + background * (~valid)
        else:
            valid = (rgb[:, :, -1:] > 0)
            out = rgb * valid + background * (~valid)
        return out.astype(np.uint8)

    def close(self):
        self.renderer.delete()


def render_mesh_video_pyrender(
    vertices: np.ndarray,      # (T, V, 3) raw SMPL vertices (y up)
    faces: np.ndarray,
    out_path: str,
    fps: int = 20,
    gt: bool = False,
    color: Optional[Sequence[float]] = None,
    resolution: Tuple[int, int] = (480, 480),
    cam: Sequence[float] = DEFAULT_CAM,
) -> str:
    """Shaded mesh video without Blender (`rendermotion.py:18-75`): center on
    the first frame's mean, render each frame, write gif/mp4."""
    import imageio

    vertices = np.asarray(vertices, np.float64)
    vertices = vertices - vertices[0].mean(axis=0)  # `rendermotion.py:37`
    color = tuple(color) if color is not None else (
        GT_COLOR if gt else DEFAULT_COLOR)

    r = PyRenderer(resolution=resolution)
    try:
        frames = [r.render(v, faces, cam=cam, color=color) for v in vertices]
    finally:
        r.close()

    os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".", exist_ok=True)
    if out_path.endswith(".gif"):
        imageio.mimsave(out_path, frames, duration=1.0 / fps)
    else:
        try:
            imageio.mimsave(out_path, frames, fps=fps)
        except Exception:
            out_path = os.path.splitext(out_path)[0] + ".gif"
            imageio.mimsave(out_path, frames, duration=1.0 / fps)
    return out_path
