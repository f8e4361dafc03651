"""MotionDiffuse-style stylization layers of the EgoBody denoiser
(`seeme_tpu/nn/stylization.py`). Zero-initialized output projections are
zeroed by `nn.init.init_parameters_`. Dropout, active in train mode only,
sits in `StylizationBlock` before its output projection, after the stylized
FFN's GELU, and in the MD layer's self-attention block
(`seeme_tpu/nn/stylization.py:47`, `:107`, `:146`)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import TransformerEncoderLayer


class StylizationBlock(nn.Module):
    """h <- out_linear(silu(norm(h) * (1 + scale) + shift)),
    (scale, shift) = emb_linear(silu(emb))."""

    def __init__(self, latent_dim: int, time_embed_dim: int, dropout: float = 0.1):
        super().__init__()
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(time_embed_dim, 2 * latent_dim))
        self.norm = nn.LayerNorm(latent_dim)
        self.out_layers = nn.Sequential(nn.SiLU(), nn.Dropout(dropout),
                                        nn.Linear(latent_dim, latent_dim))

    def forward(self, h, emb):  # h (B, T, D), emb (B, E)
        scale, shift = self.emb_layers(emb)[:, None, :].chunk(2, dim=-1)
        return self.out_layers(self.norm(h) * (1 + scale) + shift)


class LinearTemporalCrossAttention(nn.Module):
    """Linear cross attention: softmax over features for the query, over
    condition tokens for the key; a padded condition token (False in
    `xf_valid_mask`) enters that softmax at -1e9
    (`seeme_tpu/nn/stylization.py:77-82`)."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int, time_embed_dim: int,
                 dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.norm = nn.LayerNorm(latent_dim)
        self.text_norm = nn.LayerNorm(text_latent_dim)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(text_latent_dim, latent_dim)
        self.value = nn.Linear(text_latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dropout)

    def forward(self, x, xf, emb, xf_valid_mask: Optional[torch.Tensor] = None):
        B, T, D = x.shape
        N = xf.shape[1]
        H = self.num_heads
        xfn = self.text_norm(xf)
        query = torch.softmax(self.query(self.norm(x)).reshape(B, T, H, -1), dim=-1)
        key_logits = self.key(xfn).reshape(B, N, H, -1)
        if xf_valid_mask is not None:
            key_logits = key_logits.masked_fill(~xf_valid_mask[:, :, None, None], -1e9)
        key = torch.softmax(key_logits, dim=1)
        value = self.value(xfn).reshape(B, N, H, -1)
        attention = torch.einsum("bnhd,bnhl->bhdl", key, value)
        y = torch.einsum("bnhd,bhdl->bnhl", query, attention).reshape(B, T, D)
        return x + self.proj_out(y, emb)


class StylizedFFN(nn.Module):
    def __init__(self, latent_dim: int, ffn_dim: int, time_embed_dim: int, dropout: float = 0.1):
        super().__init__()
        self.linear1 = nn.Linear(latent_dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, latent_dim)
        self.dropout = nn.Dropout(dropout)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dropout)

    def forward(self, x, emb):
        h = self.linear2(self.dropout(F.gelu(self.linear1(x))))
        return x + self.proj_out(h, emb)


class MdTransformerLayer(nn.Module):
    """Self-attention over [x; xf; time] (post-norm, ff 1024, relu), keeping
    the x tokens; then linear cross-attention over xf; then the stylized FFN.
    `xf_valid_mask` (B, N), True = valid, keeps padded condition tokens out
    of both attentions (`seeme_tpu/nn/stylization.py:126-160`)."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int = 128,
                 text_latent_dim: Optional[int] = None, dropout: float = 0.1):
        super().__init__()
        self.sa_block = TransformerEncoderLayer(d_model, num_heads, 1024, "relu", dropout)
        self.ca_block = LinearTemporalCrossAttention(
            d_model, text_latent_dim or d_model, num_heads, d_model, dropout)
        self.ffn = StylizedFFN(d_model, ffn_dim, d_model, dropout)

    def forward(self, x, xf, emb, xf_valid_mask: Optional[torch.Tensor] = None):
        # x (B, T, D), xf (B, N, D), emb (B, 1, D)
        B, T = x.shape[:2]
        key_valid = None
        if xf_valid_mask is not None:
            ones = torch.ones(B, T, dtype=torch.bool, device=x.device)
            key_valid = torch.cat([ones, xf_valid_mask, ones[:, :1]], dim=1)
        x = self.sa_block(torch.cat([x, xf, emb], dim=1), key_valid)[:, :T]
        x = self.ca_block(x, xf, emb[:, 0], xf_valid_mask)
        return self.ffn(x, emb[:, 0])
