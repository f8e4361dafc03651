"""Kernel 5's operations (`ddim_tok_kernel`, the token-concat denoiser's
whole reverse process), counted from the algorithm's shapes as `counts.py`
counts the other kernels': 2 per multiply-add of every product. Its bytes
are `counts.ddim_bytes`."""

from __future__ import annotations

from typing import Mapping, Sequence

from .reference.plain import uskip_layers


def _wf(shapes: Mapping[str, Sequence[int]], name: str) -> float:
    """Operations a row through a Linear weight (out, in)."""
    return 2.0 * shapes[name][0] * shapes[name][1]


def ddim_tok_flops(shapes: Mapping[str, Sequence[int]], num_layers: int, rows: int,
                   n_cond: int, steps: int, tokens: int = 1) -> float:
    """Kernel 5, from the denoiser's weight shapes (keys without the
    `denoiser.` prefix): every step, each of the S = tokens + 1 + n_cond
    token rows of each of `rows` sequences (2 x batch under guidance)
    through every layer (q, k and v, out_proj, the two feed-forward
    products, and attention's 4 D S a row: its S logits and S values over
    the D columns of all heads) and the skip Linears. The condition
    projection and the time tokens run outside the kernel, once a window."""
    D = shapes["encoder.norm.weight"][0]
    S = tokens + 1 + n_cond
    row = 0.0
    for name in uskip_layers("encoder", num_layers):
        row += _wf(shapes, f"{name}.self_attn.in_proj_weight") + 4.0 * D * S
        row += _wf(shapes, f"{name}.self_attn.out_proj.weight")
        row += _wf(shapes, f"{name}.linear1.weight") + _wf(shapes, f"{name}.linear2.weight")
    for j in range((num_layers - 1) // 2):
        row += _wf(shapes, f"encoder.linear_blocks.{j}.weight")
    return steps * rows * S * row
