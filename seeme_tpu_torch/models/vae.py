"""Transformer motion VAE, encode/decode (`seeme_tpu/models/vae.py`).

arch='encoder_decoder' with MLP_DIST off, the shipped configuration: learned
distribution tokens prepended to the embedded frames, a U-skip encoder, and
a U-skip decoder that cross-attends zero queries against the latent.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.masks import lengths_to_mask
from ..nn.embeddings import build_position_encoding
from ..nn.transformer import (
    SkipTransformerDecoder,
    SkipTransformerEncoder,
    TransformerDecoderLayer,
    TransformerEncoderLayer,
)


class MotionVae(nn.Module):
    def __init__(self, nfeats: int, latent_dim: Sequence[int] = (1, 256), ff_size: int = 128,
                 num_layers: int = 5, num_heads: int = 1, activation: str = "gelu",
                 position_embedding: str = "learned"):
        super().__init__()
        self.latent_size = latent_dim[0]
        d = self.d_model = latent_dim[-1]
        self.query_pos_encoder = build_position_encoding(d, position_embedding)
        self.query_pos_decoder = build_position_encoding(d, position_embedding)
        self.encoder = SkipTransformerEncoder(
            lambda: TransformerEncoderLayer(d, num_heads, ff_size, activation), num_layers, d)
        self.decoder = SkipTransformerDecoder(
            lambda: TransformerDecoderLayer(d, num_heads, ff_size, activation), num_layers, d)
        self.global_motion_token = nn.Parameter(torch.empty(2 * self.latent_size, d))
        self.skel_embedding = nn.Linear(nfeats, d)
        self.final_layer = nn.Linear(d, nfeats)

    def encode(self, features: torch.Tensor,
               lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, nfeats) -> (mu, logvar), each (B, latent_size, d_model)."""
        B, T, _ = features.shape
        mask = (lengths_to_mask(lengths, T) if lengths is not None
                else torch.ones(B, T, dtype=torch.bool, device=features.device))
        x = self.skel_embedding(features)
        dist_tokens = self.global_motion_token[None].expand(B, -1, -1)
        xseq = self.query_pos_encoder(torch.cat([dist_tokens, x], dim=1))
        aug_mask = torch.cat([torch.ones(B, dist_tokens.shape[1], dtype=torch.bool,
                                         device=mask.device), mask], dim=1)
        dist = self.encoder(xseq, key_valid_mask=aug_mask)[:, : dist_tokens.shape[1]]
        return dist[:, : self.latent_size], dist[:, self.latent_size:]

    def decode(self, z: torch.Tensor, nframes: int,
               lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, latent_size, D) latent -> (B, nframes, nfeats) motion features.
        Frames past `lengths` (every frame when None) are masked as keys of
        the decoder's self-attention."""
        B = z.shape[0]
        mask = (lengths_to_mask(lengths.to(z.device), nframes) if lengths is not None
                else torch.ones(B, nframes, dtype=torch.bool, device=z.device))
        queries = self.query_pos_decoder(z.new_zeros(B, nframes, self.d_model))
        return self.final_layer(self.decoder(queries, z, tgt_valid_mask=mask))
