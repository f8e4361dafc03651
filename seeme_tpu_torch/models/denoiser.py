"""Latent-diffusion denoiser, `md_trans=True` path (`seeme_tpu/models/denoiser.py`).

Sinusoidal timestep embedding -> MLP, optional relu->Linear condition
projection, then a U-skip stack of MD stylization layers over the latent
tokens, each conditioned on (condition tokens, time token).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.embeddings import TimestepEmbedding, build_position_encoding, sinusoidal_timestep_embedding
from ..nn.stylization import MdTransformerLayer
from ..nn.transformer import SkipTransformerEncoder


class Denoiser(nn.Module):
    def __init__(self, latent_dim: Sequence[int] = (1, 256), ff_size: int = 128,
                 num_layers: int = 5, num_heads: int = 1, flip_sin_to_cos: bool = True,
                 freq_shift: float = 0.0, text_encoded_dim: int = 256,
                 position_embedding: str = "learned"):
        super().__init__()
        d = self.d_model = latent_dim[-1]
        self.num_layers = num_layers
        self.flip_sin_to_cos = flip_sin_to_cos
        self.freq_shift = freq_shift
        self.text_encoded_dim = text_encoded_dim
        self.time_embedding = TimestepEmbedding(text_encoded_dim, d)
        if text_encoded_dim != d:
            # reference: Sequential(ReLU, Linear), `mld_denoiser.py:72-74`
            self.emb_proj = nn.Sequential(nn.ReLU(), nn.Linear(text_encoded_dim, d))
        self.query_pos = build_position_encoding(d, position_embedding)
        self.encoder = SkipTransformerEncoder(
            lambda: MdTransformerLayer(d, num_heads, ffn_dim=ff_size), num_layers, d)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        """sample (B, n_tok, D), timesteps (B,), cond (B, n_cond, text_dim)."""
        B = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device).expand(B)
        t_emb = sinusoidal_timestep_embedding(
            timesteps, self.text_encoded_dim, self.flip_sin_to_cos, self.freq_shift
        ).to(sample.dtype)
        time_emb = self.time_embedding(t_emb)[:, None, :]
        cond_emb = self.emb_proj(cond) if hasattr(self, "emb_proj") else cond
        xseq = self.query_pos(sample)
        return self.encoder(xseq, xf=cond_emb, emb=time_emb)
