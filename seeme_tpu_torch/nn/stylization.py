"""MotionDiffuse-style stylization layers of the EgoBody denoiser
(`seeme_tpu/nn/stylization.py`). Zero-initialized output projections are
zeroed by `nn.init.init_parameters_`."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import TransformerEncoderLayer


class StylizationBlock(nn.Module):
    """h <- out_linear(silu(norm(h) * (1 + scale) + shift)),
    (scale, shift) = emb_linear(silu(emb))."""

    def __init__(self, latent_dim: int, time_embed_dim: int):
        super().__init__()
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(time_embed_dim, 2 * latent_dim))
        self.norm = nn.LayerNorm(latent_dim)
        self.out_layers = nn.Sequential(nn.SiLU(), nn.Dropout(0.0), nn.Linear(latent_dim, latent_dim))

    def forward(self, h, emb):  # h (B, T, D), emb (B, E)
        scale, shift = self.emb_layers(emb)[:, None, :].chunk(2, dim=-1)
        return self.out_layers(self.norm(h) * (1 + scale) + shift)


class LinearTemporalCrossAttention(nn.Module):
    """Linear cross attention: softmax over features for the query, over
    condition tokens for the key."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int, time_embed_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = nn.LayerNorm(latent_dim)
        self.text_norm = nn.LayerNorm(text_latent_dim)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(text_latent_dim, latent_dim)
        self.value = nn.Linear(text_latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim)

    def forward(self, x, xf, emb):
        B, T, D = x.shape
        N = xf.shape[1]
        H = self.num_heads
        xfn = self.text_norm(xf)
        query = torch.softmax(self.query(self.norm(x)).reshape(B, T, H, -1), dim=-1)
        key = torch.softmax(self.key(xfn).reshape(B, N, H, -1), dim=1)
        value = self.value(xfn).reshape(B, N, H, -1)
        attention = torch.einsum("bnhd,bnhl->bhdl", key, value)
        y = torch.einsum("bnhd,bhdl->bnhl", query, attention).reshape(B, T, D)
        return x + self.proj_out(y, emb)


class StylizedFFN(nn.Module):
    def __init__(self, latent_dim: int, ffn_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear1 = nn.Linear(latent_dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim)

    def forward(self, x, emb):
        h = self.linear2(F.gelu(self.linear1(x)))
        return x + self.proj_out(h, emb)


class MdTransformerLayer(nn.Module):
    """Self-attention over [x; xf; time] (post-norm, ff 1024, relu), keeping
    the x tokens; then linear cross-attention over xf; then the stylized FFN."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int = 128,
                 text_latent_dim: Optional[int] = None):
        super().__init__()
        self.sa_block = TransformerEncoderLayer(d_model, num_heads, 1024, "relu")
        self.ca_block = LinearTemporalCrossAttention(
            d_model, text_latent_dim or d_model, num_heads, d_model)
        self.ffn = StylizedFFN(d_model, ffn_dim, d_model)

    def forward(self, x, xf, emb):  # x (B, T, D), xf (B, N, D), emb (B, 1, D)
        T = x.shape[1]
        x = self.sa_block(torch.cat([x, xf, emb], dim=1))[:, :T]
        x = self.ca_block(x, xf, emb[:, 0])
        return self.ffn(x, emb[:, 0])
