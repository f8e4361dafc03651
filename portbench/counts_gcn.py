"""EgoHMR's reverse process (the steps of `EgoHmr.sample` between the encode
and the final forward) counted from the weight shapes, whatever implements
it, as `counts.py` counts the kernels: 2 operations per multiply-add of
every product, each input read once and each output written once.

A step runs the modulated GCN over 2B x 24 joint rows (the conditioned and
the scene-only branch of each of B samples): each graph conv's two weight
products over every row and its two 24 x 24 adjacency products over every
row's channels; the noisy rot6d's embedding over B x 24 rows (the two
branches share it) and the timestep's MLP once (every row shares it). The
condition's share of the input conv is counted every step, so hoisting it
out of the loop changes the time and not the count."""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

JOINTS = 24
PREFIXES = ("diffusion_model.", "embed_timestep.", "input_process.")


def gcn_shapes(sd: Mapping[str, torch.Tensor]) -> Dict[str, Sequence[int]]:
    """The shapes of the reverse process's weights in a system state dict."""
    return {k: tuple(v.shape) for k, v in sd.items() if k.startswith(PREFIXES)}


def gcn_numels(sd: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    return {k: v.numel() for k, v in sd.items() if k.startswith(PREFIXES)}


def step_flops(shapes: Mapping[str, Sequence[int]], batch: int) -> float:
    """One step's operations at batch B."""
    rows = 2 * batch * JOINTS
    total = 0.0
    for name, shape in shapes.items():
        if name.endswith(".W"):                      # (2, in, out)
            _, n_in, n_out = shape
            total += rows * 2 * (2.0 * n_in * n_out) + rows * 2 * (2.0 * JOINTS * n_out)
    emb_out, emb_in = shapes["input_process.poseEmbedding.weight"]
    total += batch * JOINTS * 2.0 * emb_out * emb_in
    for k in ("0", "2"):
        out, inp = shapes[f"embed_timestep.time_embed.{k}.weight"]
        total += 2.0 * out * inp
    return total


def reverse_flops(shapes: Mapping[str, Sequence[int]], batch: int, steps: int) -> float:
    return steps * step_flops(shapes, batch)


def reverse_bytes(numels: Mapping[str, int], batch: int, steps: int, cond_width: int) -> float:
    """The weights, the two branches' condition rows, the initial state and
    the steps' noise (B x 144 each, one draw fewer than steps), the visibility
    and the final state, in f32."""
    state = batch * JOINTS * 6
    return 4.0 * (sum(numels.values()) + 2 * batch * JOINTS * cond_width + steps * state
                  + batch * JOINTS + state)
