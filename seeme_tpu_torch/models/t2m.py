"""Text-to-motion system (`seeme_tpu/models/t2m.py`): MLD's HumanML3D / KIT
model, for training and evaluation.

`MotionVae` (its own depth and width when `vae_num_layers` / `vae_ff_size`
are set) and a token-concat `Denoiser` conditioned on text embeddings,
under the reference's state-dict names (`vae.*`, `denoiser.*`). With
`vae_type="no"` there is no VAE: the denoiser (`arch="trans_dec"` in the
shipped config) runs over the padded per-frame features.

  * `vae_loss`: reconstruction of the features and of the RIC joints, and
    the KL term (`:116-148`);
  * `diffusion_loss`: noise prediction with whole-sample text dropout at
    rate `guidance_uncondp`, at any guidance; with `vae_type="no"` the
    target is masked past each length (`:151-187`);
  * `sample` (`:190-268`): classifier-free guidance doubles the condition
    as [zeros; text] (and a `cond_mask` with it). A model with a VAE, the
    token-concat arch, at most `TOK_MAX_COND` condition tokens, no mask and
    `use_fused` (`:229-231`) runs the whole reverse process in one launch
    of `csrc/ddim_tok.cu` (`ddim_fused_tok`, its attention in the model's
    `num_heads`; on the CPU its plain version);
    every other model (the token text modes, `vae_type="no"`, trans_dec)
    runs the `ddim_sample` loop over the eager denoiser, as the JAX
    package's does;
  * `reconstruct` (`:270-278`) and `feats_to_joints` (RIC recovery in
    float64).

Random draws come from an explicit generator, or are injected as `draws`
(`loss_draws` says which). `train/state.py::set_stage` owns the modules'
grad and train modes; the constructor leaves the sampling default (all
frozen, eval mode). `text_encoder` is the host-side caption encoder
(`models/text_encoder.py`) that `encode_captions` applies to a batch
without `text_emb`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..core.masks import lengths_to_mask
from ..data.humanml import feats2joints
from ..diffusion.sampling import ddim_sample
from ..diffusion.schedulers import DiffusionSchedule
from ..nn.init import init_parameters_
from ..ops import module_state, tensor_versions
from ..ops.denoiser_fused import TOK_MAX_COND, KernelWeights, ddim_fused_tok
from ..parallel.mesh import rows
from ..train.losses import diffusion_losses, kl_standard_normal, smooth_l1
from ..train.state import set_stage
from ..utils.profiling import span
from .denoiser import Denoiser
from .text_encoder import ClipTextEncoder
from .vae import MotionVae, reparameterize

VAE_TYPES = ("mld", "no")


@dataclass(frozen=True)
class T2MConfig:
    """`seeme_tpu/models/t2m.py::T2MConfig`'s fields (the defaults are the
    JAX package's), the data sampler's shortest clip, and the text
    encoder's model path and mode (`model.text_encoder.params`: none and
    pooled in the shipped configs)."""

    nfeats: int = 263
    max_len: int = 196                     # DATASET.SAMPLER.MAX_LEN
    min_len: int = 40                      # DATASET.SAMPLER.MIN_LEN, the data's shortest clip
    latent_dim: Tuple[int, int] = (1, 256)
    ff_size: int = 128
    num_layers: int = 5
    num_heads: int = 1
    dropout: float = 0.1
    text_encoded_dim: int = 768
    guidance_scale: float = 7.5
    guidance_uncondp: float = 0.1
    num_inference_timesteps: int = 50
    lambda_kl: float = 1e-4
    lambda_rec: float = 1.0
    lambda_joint: float = 1.0
    vae_type: str = "mld"                  # "mld", or "no": diffusion over the features
    vae_num_layers: Optional[int] = None   # None: the denoiser's
    vae_ff_size: Optional[int] = None      # None: the denoiser's
    arch: str = "trans_enc"                # or "trans_dec"
    mlp_dist: bool = False                 # TRAIN.ABLATION.MLP_DIST
    text_encoder_path: str = ""            # model.text_encoder.params.modelpath
    last_hidden_state: bool = False        # model.text_encoder.params.last_hidden_state
    use_fused: bool = True                 # model.use_fused / TEST.USE_FUSED: false takes the loop


class T2MSystem(nn.Module):
    def __init__(self, cfg: T2MConfig, mean, std, device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        if cfg.vae_type not in VAE_TYPES:
            raise ValueError(f"vae_type {cfg.vae_type!r} is not one of {VAE_TYPES}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.diffusion_only = cfg.vae_type == "no"
        if not self.diffusion_only:
            self.vae = MotionVae(cfg.nfeats, cfg.latent_dim, cfg.vae_ff_size or cfg.ff_size,
                                 cfg.vae_num_layers or cfg.num_layers, cfg.num_heads,
                                 dropout=cfg.dropout, mlp_dist=cfg.mlp_dist)
        self.denoiser = Denoiser(cfg.latent_dim, cfg.ff_size, cfg.num_layers, cfg.num_heads,
                                 text_encoded_dim=cfg.text_encoded_dim, md_trans=False,
                                 dropout=cfg.dropout, arch=cfg.arch,
                                 diffusion_only=self.diffusion_only, nfeats=cfg.nfeats)
        init_parameters_(self, torch.Generator().manual_seed(seed))
        set_stage(self, None)
        self.to(dev)
        self.device = dev
        self.register_buffer("mean", torch.as_tensor(mean, dtype=torch.float32, device=dev),
                             persistent=False)
        self.register_buffer("std", torch.as_tensor(std, dtype=torch.float32, device=dev),
                             persistent=False)
        self.schedule = DiffusionSchedule()
        self.text_encoder = ClipTextEncoder(cfg.text_encoder_path or None,
                                            latent_dim=cfg.text_encoded_dim,
                                            last_hidden_state=cfg.last_hidden_state, device=dev)
        self._kernel_operands = None

    def kernel_operands(self):
        """(denoiser state dict, token-kernel weights), made again whenever a
        denoiser tensor changed since they were made."""
        key = tensor_versions(self.denoiser)
        if self._kernel_operands is None or self._kernel_operands[0] != key:
            sd = module_state(self.denoiser)
            self._kernel_operands = (key, (sd, KernelWeights(sd, self.cfg.num_layers, False,
                                                             self.cfg.num_heads)))
        return self._kernel_operands[1]

    def takes_kernel(self, n_cond: int, cond_mask: Optional[torch.Tensor]) -> bool:
        """Whether `sample` runs the token kernel: the pooled VAE model, at
        any number of latent tokens and heads, unless `use_fused` is off
        (`seeme_tpu/models/t2m.py:225-250`); a shape the kernel cannot take
        raises there, naming the limit."""
        cfg = self.cfg
        return (cfg.use_fused and not self.diffusion_only and cfg.arch == "trans_enc"
                and n_cond <= TOK_MAX_COND and cond_mask is None)

    def encode_captions(self, batch: Dict) -> Dict:
        """A host batch with its captions replaced by `text_emb` (and, in the
        token modes, `text_mask`) from `text_encoder` when it has none."""
        batch = dict(batch)
        texts = batch.pop("text", None)
        if "text_emb" not in batch and texts is not None:
            batch["text_emb"] = self.text_encoder(texts)
            mask = self.text_encoder.token_mask(texts)
            if mask is not None:
                batch["text_mask"] = mask
        return batch

    # --------------------------------------------------------------- training
    def loss_draws(self, stage: str, batch: Dict, generator: Optional[torch.Generator] = None,
                   shard: Tuple[int, int] = (0, 1)) -> Dict[str, torch.Tensor]:
        """The draws of one loss call from `generator`: `eps` of the
        reparameterization (with a VAE); in stage 2 also `drop` (B, 1, 1),
        the samples whose text is dropped, `noise` and `timesteps`. With
        `shard` (rank, ranks) they are made at the whole batch's shape and
        the rank's rows returned (`SeeMeSystem.loss_draws`)."""
        cfg = self.cfg
        motion = batch["motion"]
        dev, B = motion.device, motion.shape[0] * shard[1]
        latent = (B, *cfg.latent_dim)
        draws = {} if self.diffusion_only else {
            "eps": torch.randn(latent, generator=generator, device=dev)}
        if stage == "vae":
            return {k: rows(v, shard) for k, v in draws.items()}
        draws["drop"] = torch.rand((B, 1, 1), generator=generator, device=dev) < cfg.guidance_uncondp
        draws["noise"] = torch.randn((B, *motion.shape[1:]) if self.diffusion_only else latent,
                                     generator=generator, device=dev)
        draws["timesteps"] = torch.randint(0, self.schedule.num_train_timesteps, (B,),
                                           generator=generator, device=dev)
        return {k: rows(v, shard) for k, v in draws.items()}

    def vae_loss(self, batch: Dict, generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict] = None):
        """Stage-1 loss: (total, terms) with `recons_feature`,
        `recons_joints` and `kl_motion`, over each sequence's valid frames."""
        if self.diffusion_only:
            raise ValueError("the vae stage is undefined for vae_type 'no' "
                             "(config_novae_*: train the diffusion stage only)")
        cfg = self.cfg
        draws = draws if draws is not None else self.loss_draws("vae", batch, generator)
        motion, lengths = batch["motion"], batch["length"]
        mu, logvar = self.vae.encode(motion, lengths)
        rst = self.vae.decode(reparameterize(mu, logvar, draws["eps"]), cfg.max_len, lengths)
        mask = lengths_to_mask(lengths, cfg.max_len)[..., None].to(motion.dtype)
        terms = {"recons_feature": smooth_l1(rst * mask, motion * mask)}
        m4 = mask[..., None]
        terms["recons_joints"] = smooth_l1(feats2joints(rst, self.mean, self.std) * m4,
                                           feats2joints(motion, self.mean, self.std) * m4)
        terms["kl_motion"] = kl_standard_normal(mu, logvar)
        terms["total"] = (cfg.lambda_rec * terms["recons_feature"]
                          + cfg.lambda_joint * terms["recons_joints"]
                          + cfg.lambda_kl * terms["kl_motion"])
        return terms["total"], terms

    def diffusion_loss(self, batch: Dict, generator: Optional[torch.Generator] = None,
                       draws: Optional[Dict] = None):
        """Stage-2 loss: (total, terms). The latent comes from the frozen VAE
        without a gradient; with `vae_type="no"` the noised target is the
        padded features, and the noise past each length is zeroed as the
        denoiser zeroes its output there."""
        cfg = self.cfg
        draws = draws if draws is not None else self.loss_draws("diffusion", batch, generator)
        motion, lengths = batch["motion"], batch["length"]
        text_emb = batch["text_emb"]
        if text_emb.dim() == 2:
            text_emb = text_emb[:, None, :]
        if self.diffusion_only:
            z = motion
        else:
            with torch.no_grad():
                mu, logvar = self.vae.encode(motion, lengths)
                z = reparameterize(mu, logvar, draws["eps"])
        text_emb = text_emb.masked_fill(draws["drop"].to(torch.bool), 0.0)
        noise, timesteps = draws["noise"], draws["timesteps"]
        pred = self.denoiser(self.schedule.add_noise(z, noise, timesteps), timesteps, text_emb,
                             cond_mask=batch.get("text_mask"),
                             lengths=lengths if self.diffusion_only else None)
        if self.diffusion_only:
            noise = noise * lengths_to_mask(lengths, cfg.max_len)[..., None]
        return diffusion_losses(pred, noise)

    # --------------------------------------------------------------- sampling
    @torch.no_grad()
    def sample(self, text_emb: torch.Tensor, lengths: Optional[torch.Tensor] = None,
               nframes: Optional[int] = None, cond_mask: Optional[torch.Tensor] = None,
               z_init: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Text embedding (B, D) or (B, n_cond, D), with `cond_mask` (B, n_cond)
        True = valid in the token modes -> normalized motion features (B,
        nframes or max_len, nfeats). `z_init` replaces the drawn initial
        noise: (B, *latent_dim), or (B, T, nfeats) without a VAE. Frames
        past `lengths` are masked in the decoder (or zeroed by the
        diffusion-only denoiser)."""
        with span("sample"):
            cfg = self.cfg
            if text_emb.dim() == 2:
                text_emb = text_emb[:, None, :]
            text_emb = torch.as_tensor(text_emb, dtype=torch.float32, device=self.device)
            B, T = text_emb.shape[0], nframes or cfg.max_len
            doubled = cfg.guidance_scale > 1.0
            cond = torch.cat([torch.zeros_like(text_emb), text_emb]) if doubled else text_emb
            if cond_mask is not None:
                cond_mask = torch.as_tensor(cond_mask, device=self.device).to(torch.bool)
                if doubled:
                    cond_mask = torch.cat([cond_mask, cond_mask])
            if lengths is not None:
                lengths = torch.as_tensor(lengths, device=self.device)
            shape = (B, T, cfg.nfeats) if self.diffusion_only else (B, *cfg.latent_dim)
            if z_init is None:
                z_init = torch.randn(shape, generator=generator, device=self.device)
            z_init = z_init.to(self.device, torch.float32).contiguous()
            steps = cfg.num_inference_timesteps

            if self.diffusion_only:
                L = lengths if lengths is not None else torch.full((B,), T, device=self.device)
                L = torch.cat([L, L]) if doubled else L
                return ddim_sample(lambda x, t: self.denoiser(x, t, cond, cond_mask, L),
                                   self.schedule, shape, steps, cfg.guidance_scale, z_init=z_init)
            if self.takes_kernel(cond.shape[1], cond_mask):
                sd, weights = self.kernel_operands()
                z = ddim_fused_tok(sd, cond.contiguous(), z_init, self.schedule, steps,
                                   cfg.num_layers, cfg.guidance_scale, weights=weights)
            else:
                z = ddim_sample(lambda x, t: self.denoiser(x, t, cond, cond_mask), self.schedule,
                                shape, steps, cfg.guidance_scale, z_init=z_init)
            with span("sample.decode"):
                return self.vae.decode(z, T, lengths)

    @torch.no_grad()
    def reconstruct(self, batch: Dict, generator: Optional[torch.Generator] = None,
                    eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode, a reparameterized draw, decode: normalized (B, max_len, nfeats)."""
        if self.diffusion_only:
            raise ValueError("reconstruct needs a VAE (vae_type 'no' has none)")
        mu, logvar = self.vae.encode(batch["motion"], batch["length"])
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device)
        return self.vae.decode(reparameterize(mu, logvar, eps), self.cfg.max_len,
                               batch["length"])

    def feats_to_joints(self, feats: torch.Tensor) -> torch.Tensor:
        """Normalized (B, T, nfeats) features -> (B, T, njoints, 3) joints,
        recovered in float64."""
        with span("joints"):
            return feats2joints(feats, self.mean, self.std, dtype=torch.float64)

