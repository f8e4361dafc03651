"""Transformer motion VAE, encode/decode (`seeme_tpu/models/vae.py`).

Learned distribution tokens are prepended to the embedded frames and run
through a U-skip encoder. With MLP_DIST off (every shipped config) the first
2 x latent_size outputs are (mu, logvar); with `mlp_dist` latent_size tokens
go through a 2d-wide `dist_layer` (`seeme_tpu/models/vae.py:75-92`, `:126-132`).
arch='encoder_decoder' (shipped) decodes with a U-skip decoder that
cross-attends zero queries against the latent; arch='all_encoder' runs a
second U-skip encoder over [latent; zero queries] (`:151-160`).
`dropout` reaches every encoder and decoder layer and acts in train mode
only; `reparameterize` takes its eps from the caller.
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
                 position_embedding: str = "learned", dropout: float = 0.1,
                 arch: str = "encoder_decoder", mlp_dist: bool = False):
        super().__init__()
        if arch not in ("encoder_decoder", "all_encoder"):
            raise ValueError(f"unsupported arch {arch}")
        self.arch, self.mlp_dist = arch, mlp_dist
        self.latent_size = latent_dim[0]
        d = self.d_model = latent_dim[-1]
        self.query_pos_encoder = build_position_encoding(d, position_embedding)
        self.query_pos_decoder = build_position_encoding(d, position_embedding)
        self.encoder = SkipTransformerEncoder(
            lambda: TransformerEncoderLayer(d, num_heads, ff_size, activation, dropout),
            num_layers, d)
        if arch == "all_encoder":
            self.decoder = SkipTransformerEncoder(
                lambda: TransformerEncoderLayer(d, num_heads, ff_size, activation, dropout),
                num_layers, d)
        else:
            self.decoder = SkipTransformerDecoder(
                lambda: TransformerDecoderLayer(d, num_heads, ff_size, activation, dropout),
                num_layers, d)
        n_tok = self.latent_size if mlp_dist else 2 * self.latent_size
        self.global_motion_token = nn.Parameter(torch.empty(n_tok, d))
        if mlp_dist:
            self.dist_layer = nn.Linear(d, 2 * d)
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
        if self.mlp_dist:
            dist = self.dist_layer(dist)
            return dist[..., : self.d_model], dist[..., self.d_model:]
        return dist[:, : self.latent_size], dist[:, self.latent_size:]

    def decode(self, z: torch.Tensor, nframes: int,
               lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, latent_size, D) latent -> (B, nframes, nfeats) motion features.
        Frames past `lengths` (every frame when None) are masked as keys of
        the decoder's self-attention."""
        B = z.shape[0]
        mask = (lengths_to_mask(lengths.to(z.device), nframes) if lengths is not None
                else torch.ones(B, nframes, dtype=torch.bool, device=z.device))
        queries = z.new_zeros(B, nframes, self.d_model)
        if self.arch == "all_encoder":
            xseq = self.query_pos_decoder(torch.cat([z, queries], dim=1))
            aug_mask = torch.cat([torch.ones(B, self.latent_size, dtype=torch.bool,
                                             device=z.device), mask], dim=1)
            out = self.decoder(xseq, key_valid_mask=aug_mask)[:, self.latent_size:]
        else:
            out = self.decoder(self.query_pos_decoder(queries), z, tgt_valid_mask=mask)
        return self.final_layer(out)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor,
                   fact: Optional[float] = None) -> torch.Tensor:
    """z = mu + fact * sigma * eps (`seeme_tpu/models/vae.py:174-185`); the
    caller draws eps, shaped as mu; fact=None means fact=1."""
    if fact is not None:
        eps = eps * fact
    return mu + torch.exp(0.5 * logvar) * eps
