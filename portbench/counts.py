"""The yardstick's arithmetic: the card's peaks and the operations and bytes
of each hand-written kernel, counted from the algorithm's shapes, whatever
implements it (a frozen copy of the bound arithmetic the port's chip smoke
script and its `flops` tool use).

Operations count 2 per multiply-add of every product. Bytes count each
input read once and each output written once.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import torch

from .reference.plain import uskip_layers

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FLOPS = 989e12       # bf16 tensor cores
PEAK_BYTES = 3.35e12      # HBM3


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the operations at the bf16
    tensor-core peak or the bytes at the HBM rate, whichever is longer."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


# ----------------------------------------------------------- kernels 1 and 2
def input_block_flops(B: int, N: int, H: int) -> float:
    """Kernel 1 (`pointnet_input_block`) over B clouds of N points at hidden
    width H: fc_pos 3 -> 2H, then the first ResNet-FC block's fc_0 2H -> H,
    fc_1 H -> H and shortcut 2H -> H, for every point."""
    return 2.0 * B * N * (3 * 2 * H + 2 * H * H + H * H + 2 * H * H)


def input_block_bytes(B: int, N: int, H: int) -> float:
    """Points, fc_pos (f32), the block's biases, its three product weights
    as bf16 hi/lo pairs; the block's output and each cloud's maximum."""
    inputs = 4 * (B * N * 3 + 3 * 2 * H + 2 * H + 2 * H) + 2 * 2 * (2 * H * H + H * H + 2 * H * H)
    return inputs + 4 * (B * N * H + B * H)


def split_block_flops(B: int, N: int, H: int) -> float:
    """Kernel 2 (`pointnet_split_block`): each point's fc_0 and shortcut
    halves over x (H -> H each) and fc_1 (H -> H), and once a cloud the same
    two halves over the pooled feature."""
    return 2.0 * (B * N * 3 * H * H + 2 * B * H * H)


def split_block_bytes(B: int, N: int, H: int) -> float:
    """x, the pooled feature, the pooled halves' weights (f32) and the
    biases, the three product weights as bf16 hi/lo pairs; the output and
    each cloud's maximum."""
    inputs = 4 * (B * N * H + B * H + H * H + 2 * H + H * H) + 2 * 2 * 3 * H * H
    return inputs + 4 * (B * N * H + B * H)


# ----------------------------------------------------------- kernels 3 and 5
def _wf(shapes: Mapping[str, Sequence[int]], name: str) -> float:
    """Operations a row through a Linear weight (out, in)."""
    out, inp = shapes[name][0], shapes[name][1]
    return 2.0 * out * inp


def ddim_md_flops(shapes: Mapping[str, Sequence[int]], num_layers: int, rows: int,
                  n_cond: int, steps: int, tokens: int = 1) -> float:
    """Kernel 3 (`ddim_md_kernel`), from the denoiser's weight shapes (keys
    without the `denoiser.` prefix): once a window, the condition tokens'
    keys and values and the cross-attention's key and value; once a step,
    the time token's MLP, keys, values and both stylization rows; every
    step, each of the `tokens` latent rows of each of `rows` sequences
    through every layer (its attention over tokens + n_cond + 1 keys) and
    the skip Linears."""
    D = shapes["encoder.norm.weight"][0]
    total = steps * (_wf(shapes, "time_embedding.linear_1.weight")
                     + _wf(shapes, "time_embedding.linear_2.weight"))
    for name in uskip_layers("encoder", num_layers):
        sa, ca, ffn = f"{name}.sa_block", f"{name}.ca_block", f"{name}.ffn"
        proj = 2.0 * D * D
        total += rows * n_cond * (2 * proj + _wf(shapes, f"{ca}.key.weight")
                                  + _wf(shapes, f"{ca}.value.weight"))
        total += steps * (2 * proj + _wf(shapes, f"{ca}.proj_out.emb_layers.1.weight")
                          + _wf(shapes, f"{ffn}.proj_out.emb_layers.1.weight"))
        step = 3 * proj + 4.0 * D * (tokens + n_cond + 1)
        step += _wf(shapes, f"{sa}.self_attn.out_proj.weight")
        step += _wf(shapes, f"{sa}.linear1.weight") + _wf(shapes, f"{sa}.linear2.weight")
        step += _wf(shapes, f"{ca}.query.weight") + 4.0 * D * n_cond
        step += _wf(shapes, f"{ca}.proj_out.out_layers.2.weight")
        step += _wf(shapes, f"{ffn}.linear1.weight") + _wf(shapes, f"{ffn}.linear2.weight")
        step += _wf(shapes, f"{ffn}.proj_out.out_layers.2.weight")
        total += steps * rows * tokens * step
    for j in range((num_layers - 1) // 2):
        total += steps * rows * tokens * _wf(shapes, f"encoder.linear_blocks.{j}.weight")
    return total


def ddim_bytes(numels: Mapping[str, int], cond_rows: int, n_cond: int, batch: int,
               tokens: int, width: int, steps: int) -> float:
    """A DDIM kernel's bytes: every denoiser weight, the condition tokens of
    `cond_rows` rows (2 x batch under guidance), the initial and the final
    latents of `batch` sequences and the two schedule arrays, in f32."""
    return 4.0 * (sum(numels.values()) + cond_rows * n_cond * width
                  + 2 * batch * tokens * width + 2 * steps)


def denoiser_shapes(sd: Mapping[str, torch.Tensor]) -> Dict[str, Sequence[int]]:
    """The shapes of a system state dict's `denoiser.*` tensors, prefix cut."""
    return {k[len("denoiser."):]: tuple(v.shape) for k, v in sd.items()
            if k.startswith("denoiser.")}


def denoiser_numels(sd: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    return {k: v.numel() for k, v in sd.items() if k.startswith("denoiser.")}


def counted_flops(fn: Callable[[], object]) -> int:
    """The products `fn()` runs through PyTorch's dispatcher, by
    `torch.utils.flop_counter.FlopCounterMode` (2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()
