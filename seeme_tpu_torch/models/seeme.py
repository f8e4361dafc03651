"""SEE-ME system, sampling and training (`seeme_tpu/models/seeme.py`).

`SeeMeSystem` holds the motion VAE, the denoiser, the frozen PointNet scene
encoder and its `output_scene` projection, and for the image condition the
frozen ResNet50 `image_encoder` and its `output_images` projection, under
the reference's state-dict names (`vae.*`, `denoiser.*`,
`proscene.scene_enc.*`, `output_scene.1.*`, `output_images.1.*`; the
backbone in torchvision's layout), so
`tools/convert_checkpoint.py::convert_mld_checkpoint` reads a port state
dict as it reads a reference checkpoint.

The sampling path: `encode_conditioning` (interactee -> `MotionVae.encode`
mean; scene -> the fused PointNet blocks -> `output_scene`; image -> the
ResNet50 -> `output_images`; in that token order), then `sample_from_cond`
(the reverse process, then `MotionVae.decode`), then `eval_fk` (renorm,
SMPL joints, global-orientation quaternions). The reverse process is one
fused DDIM kernel (kernel 3 for the MD stack, kernel 5 for the
token-concat one) where `seeme_tpu/models/seeme.py:506-513` takes its
fused kernel: `use_fused`, eta 0, epsilon prediction, and one head (the
JAX kernels' attention is one head; kernel 5 also at most 8 condition tokens,
kernel 3 any count its shared memory holds, where the JAX route stops at
8 for its VMEM); every other configuration runs the `ddim_sample` loop
over the eager denoiser, as the JAX package's scan does. On the card the fused wrappers launch their CUDA
kernels; on the CPU they run their plain versions. Every shipped ego config builds: EgoBody and GIMO (21 joints,
zero-padded to SMPL's 23), the wearer or the interactee as the estimated
actor, axis-angle or rot6d features, with or without the predicted
translation.

The training losses: `vae_loss` (stage 1) and `diffusion_loss` (stage 2)
run the plain PyTorch modules, with dropout wherever a module is in train
mode. The frozen PointNet runs through the fused blocks without a gradient
(or is replaced by cached `scene_feats`); `output_scene` carries one. Every
random draw comes from `draws` (`eps`, `noise`, `timesteps`, and at
guidance > 1 the CFG masks `mask_interactee`, `mask_scene`) or, where the
caller gives none, from `generator` through `loss_draws`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..diffusion.sampling import ddim_sample
from ..core.rotations import aa_to_quat, rot6d_to_rotmat, rotmat_to_quat
from ..core.smpl import SmplModel, smpl_forward, smpl_joints24
from ..diffusion.schedulers import DiffusionSchedule
from ..nn.init import init_parameters_
from ..nn.pointnet import ResnetPointnet
from ..nn.resnet import resnet50
from ..ops.denoiser_fused import (TOK_MAX_COND, KernelWeights, ddim_fused, ddim_fused_grid,
                                  ddim_fused_tok)
from ..ops import module_state, tensor_versions
from ..ops.pointnet_fused import FusedPointnet
from ..parallel.mesh import rows
from ..train.losses import LossWeights, diffusion_losses, vae_losses, x0_losses
from ..utils.profiling import span
from .denoiser import Denoiser
from .vae import MotionVae, reparameterize

WEARER, INTERACTEE = 0, 1  # actor indices in the 2-person batch layout


@dataclass(frozen=True)
class SeeMeConfig:
    """The knobs of the ego configs (`configs/config_*_egobody*.yaml`,
    `config_*_gimo.yaml`, `config_*_interactee.yaml`) that shape the
    sampling and training graphs, as `seeme_tpu/models/seeme.py:47-100`;
    the defaults are the EgoBody flagship."""

    dataset_name: str = "egobody"       # DATASET_NAME: egobody | gimo
    estimate: str = "wearer"            # ESTIMATE: wearer | interactee
    data_type: str = "angle"            # DATA_TYPE: angle | rot6d
    predict_transl: bool = True         # TRAIN.ABLATION.PREDICT_TRANSL
    motion_length: int = 60
    condition: Tuple[str, ...] = ("interactee", "scene")
    latent_dim: Tuple[int, int] = (1, 256)
    ff_size: int = 128
    num_layers: int = 5
    num_heads: int = 1                  # model.num_head, the VAE's and the denoiser's
    dropout: float = 0.1                # model.droupout
    guidance_scale: float = 1.0
    guidance_uncondp: float = 0.1       # element-wise CFG mask rate in training
    predict_epsilon: bool = True        # TRAIN.ABLATION.PREDICT_EPSILON
    # TRAIN.ABLATION.MD_TRANS: the MD stylization stack (kernel 3), or the
    # token-concat stack (kernel 5) that the stage-1 configs build and never train
    md_trans: bool = True
    mlp_dist: bool = False              # TRAIN.ABLATION.MLP_DIST
    num_inference_timesteps: int = 50
    eta: float = 0.0                    # model.scheduler.eta: DDIM's noise scale
    scene_points: int = 20000
    scene_feat_dim: int = 512
    # the side of the synthetic image crops; the JAX package's synthetic
    # data and `init_params` use 224, the egocentric crop size
    image_size: int = 224
    # model.use_fused: false samples through the `ddim_sample` loop
    use_fused: bool = True
    # the DDIM entry, as `seeme_tpu/models/seeme.py:80`: "loop" (`ddim_fused`)
    # or "grid" (`ddim_fused_grid`); both launch `csrc/ddim_md.cu`
    fused_variant: str = "loop"
    loss: LossWeights = field(default_factory=LossWeights)

    @property
    def pose_feats(self) -> int:
        """72 axis-angle dims for EgoBody's 23-joint body plus the global
        orientation, 66 for GIMO's 21 joints; 144 for rot6d (24 joints)."""
        if self.data_type == "rot6d":
            return 144
        return 72 if self.dataset_name == "egobody" else 66

    @property
    def nfeats(self) -> int:
        if self.data_type == "rot6d":
            return 144  # rot6d features carry no translation
        return self.pose_feats + (3 if self.predict_transl else 0)

    @property
    def body_joints(self) -> int:
        return 23 if self.dataset_name == "egobody" else 21


class ConditionProjection(nn.Sequential):
    """ReLU -> Linear condition projection (`mld.py:252-261`); the Linear is
    element 1, as in the reference's `output_scene.1.*` keys."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(nn.ReLU(), nn.Linear(in_dim, out_dim))


class SeeMeSystem(nn.Module):
    def __init__(self, cfg: SeeMeConfig, smpl: SmplModel, mean, std,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if not set(cfg.condition) <= {"interactee", "scene", "image"}:
            raise ValueError(f"unknown conditions in {cfg.condition}")
        for name, value, known in (("dataset_name", cfg.dataset_name, ("egobody", "gimo")),
                                   ("estimate", cfg.estimate, ("wearer", "interactee")),
                                   ("data_type", cfg.data_type, ("angle", "rot6d"))):
            if value not in known:
                raise ValueError(f"{name} {value!r} is not one of {known}")
        if cfg.fused_variant not in ("loop", "grid"):
            raise ValueError(f"fused_variant {cfg.fused_variant!r} is not 'loop' or 'grid'")
        self.cfg = cfg
        d = cfg.latent_dim[-1]
        # `num_heads` reaches both, as `seeme_tpu/models/seeme.py:137, 146`
        self.vae = MotionVae(cfg.nfeats, cfg.latent_dim, cfg.ff_size, cfg.num_layers,
                             cfg.num_heads, dropout=cfg.dropout, mlp_dist=cfg.mlp_dist)
        self.denoiser = Denoiser(cfg.latent_dim, cfg.ff_size, cfg.num_layers, cfg.num_heads,
                                 text_encoded_dim=d, md_trans=cfg.md_trans, dropout=cfg.dropout)
        self.use_interactee = "interactee" in cfg.condition
        self.use_scene = "scene" in cfg.condition
        self.use_image = "image" in cfg.condition
        self.actor = WEARER if cfg.estimate == "wearer" else INTERACTEE
        self.other = INTERACTEE if self.actor == WEARER else WEARER
        if self.use_scene:
            self.proscene = nn.ModuleDict(
                {"scene_enc": ResnetPointnet(cfg.scene_feat_dim, hidden_dim=512)})
            self.output_scene = ConditionProjection(cfg.scene_feat_dim, d)
        if self.use_image:  # frozen backbone, trainable projection (`mld.py:182-208, 251-255`)
            self.image_encoder = resnet50()
            self.output_images = ConditionProjection(2048, d)
        init_parameters_(self, torch.Generator().manual_seed(seed))
        # the sampling default; training sets its stage's subtrees
        # (`train/state.py::set_stage`)
        self.requires_grad_(False)
        self.eval()
        self.to(dev)
        self.device = dev
        self.smpl = smpl.to(dev)
        mean = torch.as_tensor(mean, dtype=torch.float32, device=dev).reshape(-1)
        std = torch.as_tensor(std, dtype=torch.float32, device=dev).reshape(-1)
        # the full vectors hold the translation's statistics that
        # predict_transl=False renormalizes the batch's translation with
        self.register_buffer("mean_full", mean, persistent=False)
        self.register_buffer("std_full", std, persistent=False)
        self.register_buffer("mean", mean[: cfg.nfeats].clone(), persistent=False)
        self.register_buffer("std", std[: cfg.nfeats].clone(), persistent=False)
        self.schedule = DiffusionSchedule()
        self._ddim_operands = None
        self._fused_scene = FusedPointnet()

    def kernel_operands(self):
        """(denoiser state dict, DDIM kernel weights, PointNet kernel weights).
        Each kernel-layout copy is made again whenever a tensor of its own
        module (the denoiser, or the scene encoder) changed since it was made
        (by `load_state_dict`, an in-place update such as an optimizer step,
        or a move), as its storage address and version counter show; a
        training step that updates the denoiser leaves the PointNet's copy
        alone. The image encoder has no such copy: its convolutions read the
        module's own weights."""
        key = tensor_versions(self.denoiser)
        if self._ddim_operands is None or self._ddim_operands[0] != key:
            sd = module_state(self.denoiser)
            self._ddim_operands = (key, (sd, KernelWeights(sd, self.cfg.num_layers,
                                                           self.cfg.md_trans)))
        return (*self._ddim_operands[1], self._pointnet_operands())

    def _pointnet_operands(self):
        if not self.use_scene:
            return None
        return self._fused_scene.weights(self.proscene["scene_enc"])

    # ------------------------------------------------------------- primitives
    def renorm(self, feats: torch.Tensor) -> torch.Tensor:
        return feats * self.std + self.mean

    def actor_features(self, batch: Dict, actor: int) -> torch.Tensor:
        """(B, T, nfeats) normalized features of one actor: the pose
        features, plus the translation when it is predicted (rot6d features
        carry none)."""
        f = batch["feats"][:, :, actor, :]
        if self.cfg.predict_transl and self.cfg.data_type != "rot6d":
            f = torch.cat([f, batch["transl"][:, actor]], dim=-1)
        return f

    def _smpl_inputs(self, feats_raw: torch.Tensor, betas: torch.Tensor,
                     transl: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The SMPL arguments of renormalized (B, T, nfeats) features, as
        `seeme_tpu/models/seeme.py:221-271` unpacks them: rot6d features go
        through rotation matrices with the mean shape; GIMO's 21-joint pose
        is zero-padded to 23 joints; every body takes the features' own
        global orientation (the JAX package's fix of the reference's GIMO
        branch, which took the ground truth's); without predicted
        translation the batch's normalized `transl` is renormalized with the
        translation's slice of the full statistics."""
        cfg = self.cfg
        B, T, _ = feats_raw.shape
        n = B * T
        if cfg.data_type == "rot6d":
            rotmats = rot6d_to_rotmat(feats_raw.reshape(n, 24, 6), mode="diffusion")
            return dict(betas=feats_raw.new_zeros(n, 10), body_pose=rotmats[:, 1:],
                        global_orient=rotmats[:, :1], pose2rot=False)
        pose = feats_raw[..., 3: cfg.pose_feats].reshape(n, -1)
        if cfg.dataset_name == "gimo":
            pose = torch.cat([pose, pose.new_zeros(n, 6)], dim=-1)
        if cfg.predict_transl:
            trans = feats_raw[..., -3:]
        else:
            P = cfg.pose_feats
            if self.std_full.shape[0] >= P + 3:
                transl = transl * self.std_full[P: P + 3] + self.mean_full[P: P + 3]
            trans = transl
        return dict(betas=betas.reshape(n, -1), body_pose=pose,
                    global_orient=feats_raw[..., :3].reshape(n, 3), transl=trans.reshape(n, 3))

    def feats_to_joints(self, feats_raw: torch.Tensor, betas: torch.Tensor,
                        transl: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Renormalized (B, T, nfeats) features -> (B, T, 24, 3) joints;
        `transl` (B, T, 3) is the batch's normalized translation, read only
        when the features carry none."""
        B, T, _ = feats_raw.shape
        joints = smpl_joints24(self.smpl, **self._smpl_inputs(feats_raw, betas, transl))
        return joints.reshape(B, T, 24, 3)

    def feats_to_vertices(self, feats_raw: torch.Tensor, betas: torch.Tensor,
                          transl: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Renormalized (B, T, nfeats) features -> (B, T, V, 3) SMPL mesh
        vertices through the full skinning forward (the mesh-render path,
        `seeme_tpu/models/seeme.py:273-309`)."""
        B, T, _ = feats_raw.shape
        out = smpl_forward(self.smpl, **self._smpl_inputs(feats_raw, betas, transl))
        return out["vertices"].reshape(B, T, -1, 3)

    def _transl(self, batch: Dict, actor: int) -> Optional[torch.Tensor]:
        return None if self.cfg.predict_transl else batch["transl"][:, actor]

    # ---------------------------------------------------------- conditioning
    @torch.no_grad()
    def scene_features(self, scene: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) point cloud -> (B, 512) frozen PointNet features,
        through the fused blocks, without a gradient."""
        with span("encode.pointnet"):
            return self._fused_scene(self.proscene["scene_enc"], scene)

    def encode_scene(self, scene: torch.Tensor) -> torch.Tensor:
        """(B, 1, d) scene token: frozen PointNet, then the trainable
        `output_scene` projection, which carries a gradient under autograd."""
        return self.output_scene(self.scene_features(scene))[:, None, :]

    @torch.no_grad()
    def image_features(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) crops -> (B, 2048) frozen ResNet50 features, without
        a gradient; cacheable per sample as `scene_features` is."""
        with span("encode.image"):
            return self.image_encoder(image)

    def _condition_tokens(self, batch: Dict, masks: Optional[Dict] = None) -> torch.Tensor:
        """(B, n_cond, d) condition tokens [interactee, scene, image].
        `masks`, given only in training at guidance > 1, zeroes random
        elements of the raw interactee features and point cloud
        (`seeme_tpu/models/seeme.py:367-430`); cached `scene_feats` replace
        the PointNet otherwise. The image is never masked, and cached
        `image_feats` replace the ResNet50 whenever the batch has them, as in
        the JAX package."""
        tokens = []
        if self.use_interactee:
            f_int = self.actor_features(batch, INTERACTEE)
            if masks is not None:
                f_int = f_int.masked_fill(masks["mask_interactee"], 0.0)
            with torch.no_grad(), span("encode.interactee"):  # the VAE is frozen in stage 2
                mu, _ = self.vae.encode(f_int)
            tokens.append(mu)
        if self.use_scene:
            if "scene_feats" in batch and masks is None:
                tokens.append(self.output_scene(batch["scene_feats"])[:, None, :])
            else:
                scene = batch["scene"]
                if masks is not None:
                    scene = scene.masked_fill(masks["mask_scene"], 0.0)
                tokens.append(self.encode_scene(scene))
        if not tokens and not self.use_image:  # no condition: one zero token, as the JAX package
            feats = batch["feats"]
            tokens.append(feats.new_zeros(feats.shape[0], 1, self.cfg.latent_dim[-1]))
        if self.use_image:
            feats = batch["image_feats"] if "image_feats" in batch else \
                self.image_features(batch["image"])
            tokens.append(self.output_images(feats)[:, None, :])
        return torch.cat(tokens, dim=1)

    @torch.no_grad()
    def encode_conditioning(self, batch: Dict) -> torch.Tensor:
        """Eval-time condition tokens, doubled as [uncond; cond] when
        guidance > 1 (the uncond half from zeroed inputs)."""
        with span("encode"):
            cond = self._condition_tokens(batch)
            if self.cfg.guidance_scale > 1.0:
                zeroed = {k: (torch.zeros_like(v) if k in ("feats", "transl", "scene", "image")
                              else v) for k, v in batch.items()}
                return torch.cat([self._condition_tokens(zeroed), cond], dim=0)
            return cond

    # -------------------------------------------------------------- training
    def loss_draws(self, stage: str, batch: Dict, generator: Optional[torch.Generator] = None,
                   shard: Tuple[int, int] = (0, 1)) -> Dict[str, torch.Tensor]:
        """The random draws of one loss call from `generator` (on the batch's
        device): `eps` for the reparameterization; in stage 2 also `noise`,
        `timesteps` and, at guidance > 1, the CFG element masks. With `shard`
        (rank, ranks) the batch is a rank's rows: the draws are made at the
        whole batch's shape and the rank's rows returned, so they equal one
        process's."""
        cfg = self.cfg
        feats = batch["feats"]
        dev = feats.device
        B = feats.shape[0] * shard[1]
        latent = (B, cfg.latent_dim[0], cfg.latent_dim[-1])
        draws = {"eps": torch.randn(latent, generator=generator, device=dev)}
        if stage == "vae":
            return {k: rows(v, shard) for k, v in draws.items()}
        draws["noise"] = torch.randn(latent, generator=generator, device=dev)
        draws["timesteps"] = torch.randint(0, self.schedule.num_train_timesteps, (B,),
                                           generator=generator, device=dev)
        if cfg.guidance_scale > 1.0:
            p = cfg.guidance_uncondp
            if self.use_interactee:
                shape = (B, feats.shape[1], cfg.nfeats)
                draws["mask_interactee"] = torch.rand(shape, generator=generator, device=dev) < p
            if self.use_scene:
                draws["mask_scene"] = torch.rand((B, *batch["scene"].shape[1:]),
                                                 generator=generator, device=dev) < p
        return {k: rows(v, shard) for k, v in draws.items()}

    def vae_loss(self, batch: Dict, generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict] = None):
        """Stage-1 reconstruction loss (`seeme_tpu/models/seeme.py:337-364`):
        (total, terms)."""
        cfg = self.cfg
        draws = draws if draws is not None else self.loss_draws("vae", batch, generator)
        f_ref = self.actor_features(batch, self.actor)
        mu, logvar = self.vae.encode(f_ref)
        feats_rst = self.vae.decode(reparameterize(mu, logvar, draws["eps"]), cfg.motion_length)
        raw_ref, raw_rst = self.renorm(f_ref), self.renorm(feats_rst)
        betas, transl = batch["betas"][:, self.actor], self._transl(batch, self.actor)
        return vae_losses(raw_rst, raw_ref, self.feats_to_joints(raw_rst, betas, transl),
                          self.feats_to_joints(raw_ref, betas, transl), mu, logvar, cfg.loss,
                          cfg.predict_transl)

    def diffusion_loss(self, batch: Dict, generator: Optional[torch.Generator] = None,
                       draws: Optional[Dict] = None):
        """Stage-2 denoiser loss (`seeme_tpu/models/seeme.py:432-457`):
        (total, terms). The estimated actor's latent comes from the frozen
        VAE without a gradient."""
        cfg = self.cfg
        draws = draws if draws is not None else self.loss_draws("diffusion", batch, generator)
        with torch.no_grad():
            mu, logvar = self.vae.encode(self.actor_features(batch, self.actor))
            z = reparameterize(mu, logvar, draws["eps"])
        cond = self._condition_tokens(batch, draws if cfg.guidance_scale > 1.0 else None)
        noise, timesteps = draws["noise"], draws["timesteps"]
        pred = self.denoiser(self.schedule.add_noise(z, noise, timesteps), timesteps, cond)
        if cfg.predict_epsilon:
            return diffusion_losses(pred, noise)
        return x0_losses(pred, z)

    @torch.no_grad()
    def reconstruct(self, batch: Dict, generator: Optional[torch.Generator] = None,
                    eps: Optional[torch.Tensor] = None, sample_mean: bool = False,
                    fact: Optional[float] = None) -> torch.Tensor:
        """VAE-only eval path (`seeme_tpu/models/seeme.py:619-638`): the
        estimated actor's features through encode, the mean or a (fact-scaled)
        reparameterized draw, and decode; normalized (B, T, nfeats)."""
        mu, logvar = self.vae.encode(self.actor_features(batch, self.actor))
        if not sample_mean:
            if eps is None:
                eps = torch.randn(mu.shape, generator=generator, device=mu.device)
            mu = reparameterize(mu, logvar, eps, fact)
        return self.vae.decode(mu, self.cfg.motion_length)

    # -------------------------------------------------------------- sampling
    def takes_kernel(self, n_cond: int) -> bool:
        """Whether `sample_from_cond` runs a fused DDIM kernel for `n_cond`
        condition tokens: `use_fused`, eta 0 and epsilon prediction, as
        `seeme_tpu/models/seeme.py:506-513`, and one head (the JAX kernel's
        attention is one head at any `num_heads`, so a multi-head model
        would sample another function than the one it trained). The JAX
        route's limit of 8 condition tokens is its kernel's VMEM budget:
        kernel 3 takes any count that fits its shared memory (its wrapper
        refuses past that), kernel 5 at most `TOK_MAX_COND`."""
        cfg = self.cfg
        return (cfg.use_fused and cfg.eta == 0.0 and cfg.predict_epsilon and cfg.num_heads == 1
                and (cfg.md_trans or n_cond <= TOK_MAX_COND))

    @torch.no_grad()
    def sample_from_cond(self, cond_full: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         z_init: Optional[torch.Tensor] = None,
                         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Reverse diffusion + VAE decode. The fused DDIM kernel where
        `takes_kernel` (through the entry `cfg.fused_variant` names; with
        more than one latent token always `ddim_fused`, as
        `seeme_tpu/models/seeme.py:532-534` routes; kernel 5 for the
        token-concat stack), else the `ddim_sample` loop over the eager
        denoiser at `cfg.eta`. z_init (B, *latent_dim) replaces the drawn
        initial noise and `noise` (steps, B, *latent_dim) the loop's
        per-step draws at eta > 0. Returns normalized features (B, T,
        nfeats)."""
        with span("sample"):
            cfg = self.cfg
            B = cond_full.shape[0] // (2 if cfg.guidance_scale > 1.0 else 1)
            shape = (B, cfg.latent_dim[0], cfg.latent_dim[-1])
            if z_init is None:
                z_init = torch.randn(shape, generator=generator, device=self.device)
            z_init = z_init.to(self.device, torch.float32).contiguous()
            if self.takes_kernel(cond_full.shape[1]):
                sd, weights, _ = self.kernel_operands()
                grid = cfg.fused_variant == "grid" and cfg.latent_dim[0] == 1
                ddim = ddim_fused_grid if grid else ddim_fused
                if not cfg.md_trans:  # the token-concat stack: kernel 5
                    ddim = ddim_fused_tok
                z = ddim(sd, cond_full.contiguous(), z_init, self.schedule,
                         cfg.num_inference_timesteps, cfg.num_layers, cfg.guidance_scale,
                         weights=weights)
            else:
                training = self.denoiser.training
                self.denoiser.eval()  # the JAX scan applies the denoiser deterministically
                try:
                    z = ddim_sample(lambda x, t: self.denoiser(x, t, cond_full), self.schedule,
                                    shape, cfg.num_inference_timesteps, cfg.guidance_scale,
                                    z_init=z_init, generator=generator, device=self.device,
                                    eta=cfg.eta, noise=noise)
                finally:
                    self.denoiser.train(training)
            with span("sample.decode"):
                return self.vae.decode(z, cfg.motion_length)

    @torch.no_grad()
    def eval_fk(self, batch: Dict, feats_rst: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Renorm, SMPL joints of the prediction, of the estimated actor's
        ground truth and of the other actor, and the global-orientation
        quaternions of the head-orientation metric (from the 6-D rotation
        for rot6d features)."""
        with span("joints"):
            cfg = self.cfg
            raw_rst = self.renorm(feats_rst)
            raw_ref = self.renorm(self.actor_features(batch, self.actor))
            raw_int = self.renorm(self.actor_features(batch, self.other))
            betas, transl = batch["betas"][:, self.actor], self._transl(batch, self.actor)
            if cfg.data_type == "rot6d":
                quat_rst = rotmat_to_quat(rot6d_to_rotmat(raw_rst[..., :6], "diffusion"))
                quat_ref = rotmat_to_quat(rot6d_to_rotmat(raw_ref[..., :6], "diffusion"))
            else:
                quat_rst, quat_ref = aa_to_quat(raw_rst[..., :3]), aa_to_quat(raw_ref[..., :3])
            return {
                "feats_rst": feats_rst,
                "joints_rst": self.feats_to_joints(raw_rst, betas, transl),
                "joints_ref": self.feats_to_joints(raw_ref, betas, transl),
                "joints_int": self.feats_to_joints(raw_int, batch["betas"][:, self.other],
                                                   self._transl(batch, self.other)),
                "quat_rst": quat_rst,
                "quat_ref": quat_ref,
            }
