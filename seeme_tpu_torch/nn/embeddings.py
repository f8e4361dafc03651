"""Timestep and positional embeddings (`seeme_tpu/nn/embeddings.py`).

Parameter names follow the reference torch modules, so a port state dict
maps onto the JAX params through `tools/convert_checkpoint.py`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def sinusoidal_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """(B,) timesteps -> (B, dim), diffusers `get_timestep_embedding`."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    emb = torch.exp(exponent / (half_dim - downscale_freq_shift))
    emb = timesteps.to(torch.float32)[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Linear -> SiLU -> Linear over the sinusoidal embedding."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class LearnedPositionalEncoding(nn.Module):
    """Additive learned PE; the parameter keeps the reference's
    (max_len, 1, d) shape."""

    def __init__(self, d_model: int, max_len: int = 500):
        super().__init__()
        self.pe = nn.Parameter(torch.empty(max_len, 1, d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, D)
        return x + self.pe[: x.shape[1], 0][None]


def build_position_encoding(d_model: int, position_embedding: str = "learned") -> nn.Module:
    if position_embedding in ("v3", "learned"):
        return LearnedPositionalEncoding(d_model)
    raise ValueError(f"not supported {position_embedding}")
