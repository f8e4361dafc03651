"""Text-to-motion system, sampling path (`seeme_tpu/models/t2m.py`).

The MLD text-to-motion model on HumanML3D: `MotionVae` and a token-concat
`Denoiser` (md_trans=False) conditioned on a pooled text embedding, under
the reference's state-dict names (`vae.*`, `denoiser.*`). `sample` doubles
the condition as [zeros; text] for classifier-free guidance, runs the whole
DDIM reverse process in one launch of `csrc/ddim_tok.cu` (`ddim_fused_tok`),
and decodes with the length mask; `feats_to_joints` recovers the 22 joints
from the RIC features. On the CPU the wrapper runs its plain version.

Not ported, and so not selectable here: the token text modes (a condition
mask, more than 8 condition tokens, which `sample` refuses), the
diffusion-only (`vae_type="no"`) and `trans_dec` variants, training, the
text encoder and the TM2T evaluator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..data.humanml import feats2joints
from ..diffusion.schedulers import DiffusionSchedule
from ..nn.init import init_parameters_
from ..ops import tensor_versions
from ..ops.denoiser_fused import TOK_MAX_COND, KernelWeights, ddim_fused_tok
from .denoiser import Denoiser
from .vae import MotionVae


@dataclass(frozen=True)
class T2MConfig:
    """The knobs of `configs/config_mld_humanml3d.yaml` that shape the
    sampling graph; the defaults are the HumanML3D model."""

    nfeats: int = 263
    max_len: int = 196
    latent_dim: Tuple[int, int] = (1, 256)
    ff_size: int = 128
    num_layers: int = 5
    text_encoded_dim: int = 768
    guidance_scale: float = 7.5
    num_inference_timesteps: int = 50


class T2MSystem(nn.Module):
    def __init__(self, cfg: T2MConfig, mean, std, device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        # one attention head, as the reference hard-codes; the kernel is single-head
        self.vae = MotionVae(cfg.nfeats, cfg.latent_dim, cfg.ff_size, cfg.num_layers)
        self.denoiser = Denoiser(cfg.latent_dim, cfg.ff_size, cfg.num_layers,
                                 text_encoded_dim=cfg.text_encoded_dim, md_trans=False)
        init_parameters_(self, torch.Generator().manual_seed(seed))
        self.requires_grad_(False)
        self.eval()
        self.to(dev)
        self.device = dev
        self.register_buffer("mean", torch.as_tensor(mean, dtype=torch.float32, device=dev),
                             persistent=False)
        self.register_buffer("std", torch.as_tensor(std, dtype=torch.float32, device=dev),
                             persistent=False)
        self.schedule = DiffusionSchedule()
        self._kernel_operands = None

    def kernel_operands(self):
        """(denoiser state dict, token-kernel weights), made again whenever a
        denoiser tensor changed since they were made."""
        key = tensor_versions(self.denoiser)
        if self._kernel_operands is None or self._kernel_operands[0] != key:
            sd = self.denoiser.state_dict()
            self._kernel_operands = (key, (sd, KernelWeights(sd, self.cfg.num_layers, False)))
        return self._kernel_operands[1]

    @torch.no_grad()
    def sample(self, text_emb: torch.Tensor, lengths: Optional[torch.Tensor] = None,
               nframes: Optional[int] = None, z_init: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Text embedding (B, 768) or (B, n_cond, 768) -> normalized motion
        features (B, nframes or max_len, nfeats). z_init (B, 1, D) replaces
        the drawn initial noise; frames past `lengths` are masked in the
        decoder."""
        cfg = self.cfg
        if text_emb.dim() == 2:
            text_emb = text_emb[:, None, :]
        if text_emb.shape[1] > TOK_MAX_COND:
            raise ValueError(f"token text modes (more than {TOK_MAX_COND} condition tokens) "
                             "are not ported yet")
        text_emb = text_emb.to(self.device, torch.float32)
        B = text_emb.shape[0]
        cond = (torch.cat([torch.zeros_like(text_emb), text_emb])
                if cfg.guidance_scale > 1.0 else text_emb)
        if z_init is None:
            z_init = torch.randn((B, *cfg.latent_dim), generator=generator, device=self.device)
        sd, weights = self.kernel_operands()
        z = ddim_fused_tok(sd, cond.contiguous(),
                           z_init.to(self.device, torch.float32).contiguous(), self.schedule,
                           cfg.num_inference_timesteps, cfg.num_layers, cfg.guidance_scale,
                           weights=weights)
        return self.vae.decode(z, nframes or cfg.max_len, lengths)

    def feats_to_joints(self, feats: torch.Tensor) -> torch.Tensor:
        """Normalized (B, T, 263) features -> (B, T, 22, 3) joints."""
        return feats2joints(feats, self.mean, self.std)
