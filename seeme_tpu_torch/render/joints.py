"""Host-side joint-skeleton rendering with matplotlib
(`seeme_tpu/render/joints.py`), numpy only besides the renderer.

The reference ships two render paths (`mld/render/`): matplotlib/pyrender
videos and a Blender mesh backend. Rendering is host work on the npy
contract the CLIs write; the Blender backend is gated on `bpy` being
importable (it is an external DCC dependency, `mld/render/blender/*`).
matplotlib is imported when a video is drawn, and a host without it gets an
`ImportError` that names it (`pyplot`).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def pyplot():
    """matplotlib's pyplot on the Agg canvas, or an ImportError naming
    matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("rendering needs matplotlib, which is not installed "
                          f"({e})") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt

SMPL_CHAINS = [
    [0, 1, 4, 7, 10],        # left leg
    [0, 2, 5, 8, 11],        # right leg
    [0, 3, 6, 9, 12, 15],    # spine + head
    [9, 13, 16, 18, 20, 22],  # left arm
    [9, 14, 17, 19, 21, 23],  # right arm
]


def render_joints_video(
    joints: np.ndarray,          # (T, J, 3)
    out_path: str,
    fps: int = 20,
    title: str = "",
    gt_joints: Optional[np.ndarray] = None,
    chains: Optional[Sequence[Sequence[int]]] = None,
) -> str:
    """Render a joint sequence to an mp4/gif; returns the written path."""
    plt = pyplot()
    import matplotlib.animation as animation

    joints = np.asarray(joints)
    T, J, _ = joints.shape
    if chains is None:
        chains = SMPL_CHAINS if J >= 24 else [
            [j for j in chain if j < J] for chain in SMPL_CHAINS
        ]

    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(111, projection="3d")
    all_pts = joints if gt_joints is None else np.concatenate([joints, gt_joints])
    center = all_pts.reshape(-1, 3).mean(0)
    radius = max(np.abs(all_pts.reshape(-1, 3) - center).max(), 1e-3)

    def draw(t):
        ax.clear()
        ax.set_xlim(center[0] - radius, center[0] + radius)
        ax.set_ylim(center[1] - radius, center[1] + radius)
        ax.set_zlim(center[2] - radius, center[2] + radius)
        ax.set_title(f"{title} frame {t}")
        ax.axis("off")
        for series, color in ((joints, "tab:blue"), (gt_joints, "tab:gray")):
            if series is None:
                continue
            fr = series[t]
            for chain in chains:
                ax.plot(fr[chain, 0], fr[chain, 1], fr[chain, 2], color=color, lw=2)
            ax.scatter(fr[:, 0], fr[:, 1], fr[:, 2], s=4, color=color)

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


def blender_available() -> bool:
    try:
        import bpy  # noqa: F401

        return True
    except Exception:
        return False
