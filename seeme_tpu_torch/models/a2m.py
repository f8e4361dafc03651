"""Action-to-motion system (`seeme_tpu/models/a2m.py`): MLD's HumanAct12 /
UESTC model, for training, sampling and evaluation.

The text-to-motion stack with a learned action-class token in place of the
text: `MotionVae` over 60 frames of 150 rot6d features, a token-concat
`Denoiser` (md_trans=False, condition width = latent width, so no
`emb_proj`) and `EmbedAction`, under the reference's state-dict names
(`vae.*`, `denoiser.*`, `embed_action.action_embedding`).

  * `vae_loss` (`:77-94`): masked smooth-L1 reconstruction plus
    `lambda_kl` times the KL term;
  * `diffusion_loss` (`:96-115`): the frozen VAE encodes without dropout
    and without a gradient, whole samples lose their action token with
    probability `guidance_uncondp`, the denoiser (dropout on in training)
    predicts the noise;
  * `sample` (`:117-156`): classifier-free guidance doubles the condition
    as [zeros; token] when guidance > 1; the whole reverse process is one
    launch of `csrc/ddim_tok.cu` (`ops/denoiser_fused.py::ddim_fused_tok`,
    kernel 5; its plain version on the CPU), then the decode. With
    `use_fused` off (`:125`), or more than one head (this route keeps
    kernel 5 at one head), it runs the `ddim_sample` loop over the eager
    denoiser;
  * `feats_to_joints` (`:158-164`): `core/rotation2xyz.py` over the
    system's SMPL body.

Random draws come from an explicit generator, or are injected as `draws`
(`loss_draws` says which). `train/state.py::set_stage` owns the modules'
grad and train modes; the constructor leaves all frozen in eval mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..core.masks import lengths_to_mask
from ..core.rotation2xyz import rot6d_motion_to_joints
from ..core.smpl import SmplModel, synthetic_smpl
from ..diffusion.sampling import ddim_sample
from ..diffusion.schedulers import DiffusionSchedule
from ..nn.action import EmbedAction
from ..nn.init import init_parameters_
from ..ops.denoiser_fused import ddim_fused_tok
from ..parallel.mesh import rows
from ..train.losses import diffusion_losses, kl_standard_normal, smooth_l1
from ..train.state import set_stage
from .denoiser import Denoiser
from .t2m import T2MSystem
from .vae import MotionVae, reparameterize


@dataclass(frozen=True)
class A2MConfig:
    """`seeme_tpu/models/a2m.py::A2MConfig`'s fields and defaults."""

    nfeats: int = 150   # 24 joints x rot6d + root trajectory, padded to 25 x 6
    num_frames: int = 60
    num_classes: int = 12
    latent_dim: Tuple[int, int] = (1, 256)
    ff_size: int = 128
    num_layers: int = 5
    num_heads: int = 1
    dropout: float = 0.1
    guidance_scale: float = 7.5
    guidance_uncondp: float = 0.1
    num_inference_timesteps: int = 50
    lambda_kl: float = 1e-4
    lambda_rec: float = 1.0
    use_fused: bool = True  # model.use_fused / TEST.USE_FUSED: false takes the loop


class A2MSystem(nn.Module):
    def __init__(self, cfg: A2MConfig, smpl: Optional[SmplModel] = None,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d = cfg.latent_dim[-1]
        self.vae = MotionVae(cfg.nfeats, cfg.latent_dim, cfg.ff_size, cfg.num_layers,
                             cfg.num_heads, dropout=cfg.dropout)
        self.denoiser = Denoiser(cfg.latent_dim, cfg.ff_size, cfg.num_layers, cfg.num_heads,
                                 text_encoded_dim=d, md_trans=False, dropout=cfg.dropout)
        self.embed_action = EmbedAction(cfg.num_classes, d)
        init_parameters_(self, torch.Generator().manual_seed(seed))
        set_stage(self, None)
        self.to(dev)
        self.device = dev
        self.smpl = (smpl if smpl is not None else synthetic_smpl(n_verts=6890)).to(dev)
        self.schedule = DiffusionSchedule()
        self._kernel_operands = None

    # the token kernel's operands, remade when a denoiser tensor changed
    kernel_operands = T2MSystem.kernel_operands

    # --------------------------------------------------------------- training
    def loss_draws(self, stage: str, batch: Dict, generator: Optional[torch.Generator] = None,
                   shard: Tuple[int, int] = (0, 1)) -> Dict[str, torch.Tensor]:
        """The draws of one loss call from `generator`: `eps` of the
        reparameterization; in stage 2 also `drop` (B, 1), the samples whose
        action token is dropped, `noise` and `timesteps`. With `shard`
        (rank, ranks) they are made at the whole batch's shape and the
        rank's rows returned (`SeeMeSystem.loss_draws`)."""
        motion = batch["motion"]
        dev, B = motion.device, motion.shape[0] * shard[1]
        latent = (B, *self.cfg.latent_dim)
        draws = {"eps": torch.randn(latent, generator=generator, device=dev)}
        if stage == "vae":
            return {k: rows(v, shard) for k, v in draws.items()}
        draws["drop"] = (torch.rand((B, 1), generator=generator, device=dev)
                         < self.cfg.guidance_uncondp)
        draws["noise"] = torch.randn(latent, generator=generator, device=dev)
        draws["timesteps"] = torch.randint(0, self.schedule.num_train_timesteps, (B,),
                                           generator=generator, device=dev)
        return {k: rows(v, shard) for k, v in draws.items()}

    def vae_loss(self, batch: Dict, generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict] = None):
        """Stage-1 loss: (total, terms) with `recons_feature` over each
        sequence's valid frames and `kl_motion`."""
        cfg = self.cfg
        draws = draws if draws is not None else self.loss_draws("vae", batch, generator)
        motion, lengths = batch["motion"], batch["length"]
        mu, logvar = self.vae.encode(motion, lengths)
        rst = self.vae.decode(reparameterize(mu, logvar, draws["eps"]), cfg.num_frames, lengths)
        mask = lengths_to_mask(lengths, cfg.num_frames)[..., None].to(motion.dtype)
        terms = {"recons_feature": smooth_l1(rst * mask, motion * mask),
                 "kl_motion": kl_standard_normal(mu, logvar)}
        terms["total"] = (cfg.lambda_rec * terms["recons_feature"]
                          + cfg.lambda_kl * terms["kl_motion"])
        return terms["total"], terms

    def diffusion_loss(self, batch: Dict, generator: Optional[torch.Generator] = None,
                       draws: Optional[Dict] = None):
        """Stage-2 loss: (total, terms); the latent comes from the frozen VAE."""
        draws = draws if draws is not None else self.loss_draws("diffusion", batch, generator)
        with torch.no_grad():
            mu, logvar = self.vae.encode(batch["motion"], batch["length"])
            z = reparameterize(mu, logvar, draws["eps"])
        cond = self.embed_action(batch["action"], drop=draws["drop"])
        noise, timesteps = draws["noise"], draws["timesteps"]
        pred = self.denoiser(self.schedule.add_noise(z, noise, timesteps), timesteps, cond)
        return diffusion_losses(pred, noise)

    # --------------------------------------------------------------- sampling
    @torch.no_grad()
    def sample(self, action_ids, lengths: Optional[torch.Tensor] = None,
               z_init: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Class ids (B,) -> motion features (B, num_frames, nfeats). `z_init`
        (B, *latent_dim) replaces the drawn initial noise; frames past
        `lengths` are masked in the decoder."""
        cfg = self.cfg
        cond = self.embed_action(torch.as_tensor(action_ids, device=self.device))
        B = cond.shape[0]
        if cfg.guidance_scale > 1.0:
            cond = torch.cat([torch.zeros_like(cond), cond])
        shape = (B, *cfg.latent_dim)
        if z_init is None:
            z_init = torch.randn(shape, generator=generator, device=self.device)
        z_init = z_init.to(self.device, torch.float32).contiguous()
        steps = cfg.num_inference_timesteps
        if cfg.use_fused and cfg.num_heads == 1:  # kernel 5 at any latent token count (:125-136)
            sd, weights = self.kernel_operands()
            z = ddim_fused_tok(sd, cond.contiguous(), z_init, self.schedule, steps,
                               cfg.num_layers, cfg.guidance_scale, weights=weights)
        else:
            z = ddim_sample(lambda x, t: self.denoiser(x, t, cond), self.schedule, shape, steps,
                            cfg.guidance_scale, z_init=z_init)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=self.device)
        return self.vae.decode(z, cfg.num_frames, lengths)

    def feats_to_joints(self, feats: torch.Tensor, translation: bool = True) -> torch.Tensor:
        """(B, T, nfeats) rot6d features -> (B, T, 24, 3) joints."""
        return rot6d_motion_to_joints(self.smpl, feats, translation=translation)
