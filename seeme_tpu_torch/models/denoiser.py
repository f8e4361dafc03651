"""Latent-diffusion denoiser (`seeme_tpu/models/denoiser.py`).

Sinusoidal timestep embedding -> MLP, optional relu->Linear condition
projection, then a U-skip stack over the latent tokens. Two block types, as
`md_trans` selects them in the reference:

  * md_trans=True (EgoBody): MD stylization layers over the latent tokens,
    each conditioned on (condition tokens, time token);
  * md_trans=False (text-to-motion): plain post-norm GELU encoder layers
    over the token sequence [sample; time; cond], keeping the first
    n_latent outputs. `cond_mask` (B, n_cond), True = valid, excludes
    padded condition tokens as attention keys.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.embeddings import TimestepEmbedding, build_position_encoding, sinusoidal_timestep_embedding
from ..nn.stylization import MdTransformerLayer
from ..nn.transformer import SkipTransformerEncoder, TransformerEncoderLayer


class Denoiser(nn.Module):
    def __init__(self, latent_dim: Sequence[int] = (1, 256), ff_size: int = 128,
                 num_layers: int = 5, num_heads: int = 1, flip_sin_to_cos: bool = True,
                 freq_shift: float = 0.0, text_encoded_dim: int = 256,
                 position_embedding: str = "learned", md_trans: bool = True):
        super().__init__()
        d = self.d_model = latent_dim[-1]
        self.num_layers = num_layers
        self.flip_sin_to_cos = flip_sin_to_cos
        self.freq_shift = freq_shift
        self.text_encoded_dim = text_encoded_dim
        self.md_trans = md_trans
        self.time_embedding = TimestepEmbedding(text_encoded_dim, d)
        if text_encoded_dim != d:
            # reference: Sequential(ReLU, Linear), `mld_denoiser.py:72-74`
            self.emb_proj = nn.Sequential(nn.ReLU(), nn.Linear(text_encoded_dim, d))
        self.query_pos = build_position_encoding(d, position_embedding)
        if md_trans:
            make_layer = lambda: MdTransformerLayer(d, num_heads, ffn_dim=ff_size)  # noqa: E731
        else:
            make_layer = lambda: TransformerEncoderLayer(d, num_heads, ff_size, "gelu")  # noqa: E731
        self.encoder = SkipTransformerEncoder(make_layer, num_layers, d)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor, cond: torch.Tensor,
                cond_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample (B, n_tok, D), timesteps (B,), cond (B, n_cond, text_dim)."""
        B, n_latent = sample.shape[:2]
        timesteps = torch.as_tensor(timesteps, device=sample.device).expand(B)
        t_emb = sinusoidal_timestep_embedding(
            timesteps, self.text_encoded_dim, self.flip_sin_to_cos, self.freq_shift
        ).to(sample.dtype)
        time_emb = self.time_embedding(t_emb)[:, None, :]
        cond_emb = self.emb_proj(cond) if hasattr(self, "emb_proj") else cond
        if self.md_trans:
            if cond_mask is not None:
                raise ValueError("Denoiser: cond_mask is not ported for md_trans=True")
            return self.encoder(self.query_pos(sample), xf=cond_emb, emb=time_emb)
        xseq = self.query_pos(torch.cat([sample, time_emb, cond_emb], dim=1))
        key_valid = None
        if cond_mask is not None:
            ones = torch.ones(B, n_latent + 1, dtype=torch.bool, device=sample.device)
            key_valid = torch.cat([ones, cond_mask.to(torch.bool)], dim=1)
        return self.encoder(xseq, key_valid_mask=key_valid)[:, :n_latent]
