"""Host-side SMPL mesh rendering (`seeme_tpu/render/mesh.py`).

The reference renders meshes with a Blender (bpy) backend
(`mld/render/blender/*`, ~1200 LoC across render/meshes/camera/materials/
floor/scene/tools). Here the pipeline is split into:

  * pure-numpy frame preparation (testable without any renderer),
  * a matplotlib `plot_trisurf` fallback (always available),
  * the full Blender backend in `blender_backend.py`, used automatically
    when `bpy` is importable.

The npy contract matches the reference: a `(T, V, 3)` vertex array (V > 1000
distinguishes mesh data from joint data, `blender/tools.py:5-9`) plus an
`(F, 3)` faces array (SMPL faces from the body-model pkl's `f` field).
Each backend is imported when it is chosen; without matplotlib the
fallback raises an `ImportError` that names it (`joints.py::pyplot`).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

# material colors from the reference (`blender/meshes.py:6-14`)
GT_COLOR = (0.035, 0.415, 0.122)   # green
GEN_COLOR = (0.658, 0.214, 0.0114)  # orange


def mesh_detect(data: np.ndarray) -> bool:
    """Vertex arrays have >1000 points per frame (`blender/tools.py:5-9`)."""
    return data.ndim == 3 and data.shape[1] > 1000


def prepare_mesh_frames(
    data: np.ndarray, always_on_floor: bool = False
) -> np.ndarray:
    """Axis swap (gravity Y -> Z) + floor removal
    (`blender/meshes.py:67-87` prepare_meshes)."""
    data = np.asarray(data, np.float64)[..., [2, 0, 1]].copy()
    data[..., 2] -= data[..., 2].min()
    if always_on_floor:
        data[..., 2] -= data[..., 2].min(axis=1)[:, None]
    return data


def sequence_color(frac: float) -> tuple:
    """Oranges colormap ramp for sequence mode (`blender/meshes.py:37-46`)."""
    from .joints import pyplot

    pyplot()
    import matplotlib

    cmap = matplotlib.colormaps["Oranges"]
    return cmap(0.50 + (0.90 - 0.50) * frac)[:3]


def get_frameidx(mode: str, nframes: int, exact_frame: Optional[float],
                 frames_to_keep: int):
    """Frame selection per render mode (`blender/sampler.py:3-15`)."""
    if mode == "sequence":
        return list(np.round(np.linspace(0, nframes - 1, frames_to_keep)).astype(int))
    if mode == "frame":
        return [int((exact_frame or 0.5) * nframes)]
    if mode == "video":
        return list(range(nframes))
    raise ValueError(f"unsupported render mode {mode}")


def render_mesh_video_matplotlib(
    vertices: np.ndarray,       # (T, V, 3), already prepared (z = up)
    faces: np.ndarray,          # (F, 3)
    out_path: str,
    fps: int = 20,
    gt: bool = False,
    title: str = "",
) -> str:
    """Fallback mesh renderer: matplotlib trisurf video (gif/mp4)."""
    from .joints import pyplot

    plt = pyplot()
    import matplotlib.animation as animation

    vertices = np.asarray(vertices)
    T = vertices.shape[0]
    color = GT_COLOR if gt else GEN_COLOR

    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(111, projection="3d")
    center = vertices.reshape(-1, 3).mean(0)
    radius = max(np.abs(vertices.reshape(-1, 3) - center).max(), 1e-3)

    def draw(t):
        ax.clear()
        ax.set_xlim(center[0] - radius, center[0] + radius)
        ax.set_ylim(center[1] - radius, center[1] + radius)
        ax.set_zlim(0, 2 * radius)
        ax.set_title(f"{title} frame {t}")
        ax.axis("off")
        v = vertices[t]
        ax.plot_trisurf(v[:, 0], v[:, 1], v[:, 2], triangles=faces,
                        color=color, shade=True, linewidth=0.0)

    anim = animation.FuncAnimation(fig, draw, frames=T, interval=1000 / fps)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".", exist_ok=True)
    if out_path.endswith(".gif"):
        anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    else:
        try:
            anim.save(out_path, writer=animation.FFMpegWriter(fps=fps))
        except Exception:
            out_path = os.path.splitext(out_path)[0] + ".gif"
            anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out_path


def render_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    out_path: str,
    mode: str = "video",
    fps: int = 20,
    gt: bool = False,
    always_on_floor: bool = False,
    exact_frame: Optional[float] = None,
    num: int = 8,
    res: str = "high",
    title: str = "",
) -> str:
    """Render a vertex sequence with the best available backend: Blender
    when `bpy` imports, the offscreen pyrender tier when `pyrender` imports
    (the reference's `mld/render/renderer.py` role), matplotlib otherwise.
    Returns the written path (video file or frames folder)."""
    from .joints import blender_available

    if blender_available():
        frames = prepare_mesh_frames(vertices, always_on_floor=always_on_floor)
        from .blender_backend import render_blender

        return render_blender(
            frames, faces, out_path, mode=mode, gt=gt,
            exact_frame=exact_frame, num=num, res=res,
        )
    if mode == "video":
        from .pyrender_backend import pyrender_available

        if pyrender_available():
            from .pyrender_backend import render_mesh_video_pyrender

            # pyrender takes RAW (y-up) vertices: the backend applies the
            # reference's own Rx(180°) + first-frame centering. Apply the
            # always_on_floor per-frame contact in y-up space first. (No
            # title overlay in this tier — the reference renderer has none.)
            verts = np.asarray(vertices, np.float64)
            if always_on_floor:
                verts = verts.copy()
                verts[..., 1] -= verts[..., 1].min(axis=1, keepdims=True)
            return render_mesh_video_pyrender(
                verts, faces, out_path, fps=fps, gt=gt,
                resolution=(480, 480) if res == "high" else (224, 224),
            )
        frames = prepare_mesh_frames(vertices, always_on_floor=always_on_floor)
        return render_mesh_video_matplotlib(
            frames, faces, out_path, fps=fps, gt=gt, title=title
        )
    frames = prepare_mesh_frames(vertices, always_on_floor=always_on_floor)
    # sequence/frame fall back to a single representative still
    from .joints import pyplot

    plt = pyplot()
    idxs = get_frameidx(mode, len(frames), exact_frame, num)
    fig = plt.figure(figsize=(5 * len(idxs), 5))
    for i, t in enumerate(idxs):
        ax = fig.add_subplot(1, len(idxs), i + 1, projection="3d")
        v = frames[t]
        color = (GT_COLOR if gt else sequence_color(
            i / max(len(idxs) - 1, 1)))
        ax.plot_trisurf(v[:, 0], v[:, 1], v[:, 2], triangles=faces,
                        color=color, shade=True, linewidth=0.0)
        ax.axis("off")
    out_path = os.path.splitext(out_path)[0] + ".png"
    os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path
