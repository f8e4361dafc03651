"""Latent-diffusion denoiser (`seeme_tpu/models/denoiser.py`).

Sinusoidal timestep embedding -> MLP, optional relu->Linear condition
projection, then one of three stacks, as `md_trans` and `arch` select them
in the reference:

  * arch="trans_enc", md_trans=True (EgoBody): a U-skip stack of MD
    stylization layers over the latent tokens, each conditioned on
    (condition tokens, time token);
  * arch="trans_enc", md_trans=False (text-to-motion): a U-skip stack of
    plain post-norm GELU encoder layers over [sample; time; cond], keeping
    the first n_latent outputs;
  * arch="trans_dec" (`configs/modules_novae/denoiser.yaml`): a plain
    decoder stack whose queries are the sample tokens and whose memory is
    [time; cond] with its own learned position encoding `mem_pos`.

`diffusion_only` (VAE_TYPE "no") denoises padded per-frame features:
`pose_embd` embeds them, `pose_proj` maps back, and frames past `lengths`
are zeroed on the way out; with trans_enc the sequence is [time; cond;
sample]. `cond_mask` (B, n_cond), True = valid, keeps padded condition
tokens out of every attention, the time token and the sample tokens always
valid (`seeme_tpu/models/denoiser.py:172-253`); on the MD stack it also
leaves them out of the cross-attention's softmax over tokens.

`dropout` reaches every layer and acts in train mode only: the training
forward is this module; the fused DDIM kernels read its state dict and
sample without dropout, as the JAX package's do.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..core.masks import lengths_to_mask
from ..nn.embeddings import TimestepEmbedding, build_position_encoding, sinusoidal_timestep_embedding
from ..nn.stylization import MdTransformerLayer
from ..nn.transformer import (
    SkipTransformerEncoder,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoderLayer,
)

ARCHS = ("trans_enc", "trans_dec")


class Denoiser(nn.Module):
    def __init__(self, latent_dim: Sequence[int] = (1, 256), ff_size: int = 128,
                 num_layers: int = 5, num_heads: int = 1, flip_sin_to_cos: bool = True,
                 freq_shift: float = 0.0, text_encoded_dim: int = 256,
                 position_embedding: str = "learned", md_trans: bool = True,
                 dropout: float = 0.1, arch: str = "trans_enc", diffusion_only: bool = False,
                 nfeats: int = 263):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"denoiser arch {arch!r} is not one of {ARCHS}")
        d = self.d_model = latent_dim[-1]
        self.num_layers = num_layers
        self.flip_sin_to_cos = flip_sin_to_cos
        self.freq_shift = freq_shift
        self.text_encoded_dim = text_encoded_dim
        self.md_trans = md_trans
        self.arch = arch
        self.diffusion_only = diffusion_only
        self.time_embedding = TimestepEmbedding(text_encoded_dim, d)
        if text_encoded_dim != d:
            # reference: Sequential(ReLU, Linear), `mld_denoiser.py:72-74`
            self.emb_proj = nn.Sequential(nn.ReLU(), nn.Linear(text_encoded_dim, d))
        self.query_pos = build_position_encoding(d, position_embedding)
        if diffusion_only:
            self.pose_embd = nn.Linear(nfeats, d)
            self.pose_proj = nn.Linear(d, nfeats)
        if arch == "trans_dec":
            self.mem_pos = build_position_encoding(d, position_embedding)
            self.decoder = TransformerDecoder(
                lambda: TransformerDecoderLayer(d, num_heads, ff_size, "gelu", dropout),
                num_layers, d)
            return
        if md_trans:
            make_layer = lambda: MdTransformerLayer(  # noqa: E731
                d, num_heads, ffn_dim=ff_size, dropout=dropout)
        else:
            make_layer = lambda: TransformerEncoderLayer(  # noqa: E731
                d, num_heads, ff_size, "gelu", dropout)
        self.encoder = SkipTransformerEncoder(make_layer, num_layers, d)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor, cond: torch.Tensor,
                cond_mask: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample (B, n_tok, D), or (B, T, nfeats) when diffusion_only;
        timesteps (B,); cond (B, n_cond, text_dim); lengths (B,) zeroes the
        diffusion-only output past each length."""
        B, n_latent = sample.shape[:2]
        dev = sample.device
        timesteps = torch.as_tensor(timesteps, device=dev).expand(B)
        t_emb = sinusoidal_timestep_embedding(
            timesteps, self.text_encoded_dim, self.flip_sin_to_cos, self.freq_shift
        ).to(sample.dtype)
        time_emb = self.time_embedding(t_emb)[:, None, :]
        cond_emb = self.emb_proj(cond) if hasattr(self, "emb_proj") else cond
        valid = None if cond_mask is None else cond_mask.to(torch.bool)
        one = torch.ones(B, 1, dtype=torch.bool, device=dev)
        if self.diffusion_only:
            sample = self.pose_embd(sample)

        if self.arch == "trans_dec":
            memory = self.mem_pos(torch.cat([time_emb, cond_emb], dim=1))
            mem_valid = None if valid is None else torch.cat([one, valid], dim=1)
            out = self.decoder(self.query_pos(sample), memory, memory_valid_mask=mem_valid)
        elif self.diffusion_only:
            n_prefix = 1 + cond_emb.shape[1]
            xseq = self.query_pos(torch.cat([time_emb, cond_emb, sample], dim=1))
            key_valid = None
            if valid is not None:
                frames = torch.ones(B, n_latent, dtype=torch.bool, device=dev)
                key_valid = torch.cat([one, valid, frames], dim=1)
            out = self.encoder(xseq, key_valid_mask=key_valid)[:, n_prefix:]
        elif self.md_trans:
            return self.encoder(self.query_pos(sample), xf=cond_emb, emb=time_emb,
                                xf_valid_mask=valid)
        else:
            xseq = self.query_pos(torch.cat([sample, time_emb, cond_emb], dim=1))
            key_valid = None
            if valid is not None:
                ones = torch.ones(B, n_latent + 1, dtype=torch.bool, device=dev)
                key_valid = torch.cat([ones, valid], dim=1)
            return self.encoder(xseq, key_valid_mask=key_valid)[:, :n_latent]

        if not self.diffusion_only:  # trans_dec over latent tokens
            return out
        out = self.pose_proj(out)
        if lengths is not None:
            out = out * lengths_to_mask(lengths.to(dev), out.shape[1])[..., None]
        return out
