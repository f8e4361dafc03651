"""SEE-ME system, sampling path (`seeme_tpu/models/seeme.py`).

`SeeMeSystem` holds the motion VAE, the denoiser, the frozen PointNet scene
encoder and its `output_scene` projection, under the reference's state-dict
names (`vae.*`, `denoiser.*`, `proscene.scene_enc.*`, `output_scene.1.*`),
so `tools/convert_checkpoint.py::convert_mld_checkpoint` reads a port state
dict as it reads a reference checkpoint.

The sampling path: `encode_conditioning` (interactee -> `MotionVae.encode`
mean; scene -> the fused PointNet blocks -> `output_scene`), then
`sample_from_cond` (the fused DDIM kernel, then `MotionVae.decode`), then
`eval_fk` (renorm, SMPL joints, global-orientation quaternions). On the card
the fused wrappers launch their CUDA kernels; on the CPU they run their
plain versions.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..core.rotations import aa_to_quat
from ..core.smpl import SmplModel, smpl_joints24
from ..diffusion.schedulers import DiffusionSchedule
from ..nn.init import init_parameters_
from ..nn.pointnet import ResnetPointnet
from ..ops.denoiser_fused import KernelWeights, ddim_fused, ddim_fused_grid
from ..ops.pointnet_fused import pointnet_forward, pointnet_weights
from .denoiser import Denoiser
from .vae import MotionVae

WEARER, INTERACTEE = 0, 1  # actor indices in the 2-person batch layout


def tensor_versions(*modules: nn.Module) -> tuple:
    """Storage address and version counter of every tensor of the modules:
    it changes with `load_state_dict`, an in-place update or a move, so it
    keys the kernel-layout weight copies."""
    return tuple((t.data_ptr(), t._version)
                 for m in modules for t in itertools.chain(m.parameters(), m.buffers()))


@dataclass(frozen=True)
class SeeMeConfig:
    """The knobs of `configs/config_mld_egobody.yaml` that shape the
    sampling graph; the defaults are the EgoBody flagship."""

    motion_length: int = 60
    condition: Tuple[str, ...] = ("interactee", "scene")
    latent_dim: Tuple[int, int] = (1, 256)
    ff_size: int = 128
    num_layers: int = 5
    guidance_scale: float = 1.0
    num_inference_timesteps: int = 50
    scene_points: int = 20000
    scene_feat_dim: int = 512
    # the DDIM entry, as `seeme_tpu/models/seeme.py:80`: "loop" (`ddim_fused`)
    # or "grid" (`ddim_fused_grid`); both launch `csrc/ddim_md.cu`
    fused_variant: str = "loop"
    pose_feats = 72  # a constant, not a field: 23-joint EgoBody pose + global orientation

    @property
    def nfeats(self) -> int:
        return self.pose_feats + 3  # + translation (ABLATION.PREDICT_TRANSL)


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
        if not set(cfg.condition) <= {"interactee", "scene"}:
            raise ValueError(f"conditions {cfg.condition} are not ported yet")
        if cfg.fused_variant not in ("loop", "grid"):
            raise ValueError(f"fused_variant {cfg.fused_variant!r} is not 'loop' or 'grid'")
        self.cfg = cfg
        d = cfg.latent_dim[-1]
        # one attention head, as the reference hard-codes (`mld_vae.py:51-53`);
        # the fused DDIM path is single-head
        self.vae = MotionVae(cfg.nfeats, cfg.latent_dim, cfg.ff_size, cfg.num_layers)
        self.denoiser = Denoiser(cfg.latent_dim, cfg.ff_size, cfg.num_layers, text_encoded_dim=d)
        self.use_interactee = "interactee" in cfg.condition
        self.use_scene = "scene" in cfg.condition
        if self.use_scene:
            self.proscene = nn.ModuleDict(
                {"scene_enc": ResnetPointnet(cfg.scene_feat_dim, hidden_dim=512)})
            self.output_scene = ConditionProjection(cfg.scene_feat_dim, d)
        init_parameters_(self, torch.Generator().manual_seed(seed))
        self.requires_grad_(False)
        self.eval()
        self.to(dev)
        self.device = dev
        self.smpl = smpl.to(dev)
        mean = torch.as_tensor(mean, dtype=torch.float32, device=dev).reshape(-1)
        std = torch.as_tensor(std, dtype=torch.float32, device=dev).reshape(-1)
        self.register_buffer("mean", mean[: cfg.nfeats].clone(), persistent=False)
        self.register_buffer("std", std[: cfg.nfeats].clone(), persistent=False)
        self.schedule = DiffusionSchedule()
        self._kernel_operands = None

    def kernel_operands(self):
        """(denoiser state dict, DDIM kernel weights, PointNet kernel weights).
        The kernel-layout copies are made again whenever a tensor of the
        denoiser or the scene encoder changed since they were made (by
        `load_state_dict`, an in-place update or a move), as its storage
        address and version counter show."""
        key = tensor_versions(self.denoiser, *([self.proscene] if self.use_scene else []))
        if self._kernel_operands is None or self._kernel_operands[0] != key:
            sd = self.denoiser.state_dict()
            scene = pointnet_weights(self.proscene["scene_enc"]) if self.use_scene else None
            self._kernel_operands = (key, (sd, KernelWeights(sd, self.cfg.num_layers), scene))
        return self._kernel_operands[1]

    # ------------------------------------------------------------- primitives
    def renorm(self, feats: torch.Tensor) -> torch.Tensor:
        return feats * self.std + self.mean

    def actor_features(self, batch: Dict, actor: int) -> torch.Tensor:
        """(B, T, nfeats) normalized pose features plus translation."""
        return torch.cat([batch["feats"][:, :, actor, :], batch["transl"][:, actor]], dim=-1)

    def feats_to_joints(self, feats_raw: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
        """Renormalized (B, T, nfeats) features -> (B, T, 24, 3) joints."""
        B, T, _ = feats_raw.shape
        pose = feats_raw[..., 3: self.cfg.pose_feats].reshape(B * T, -1)
        glob = feats_raw[..., :3].reshape(B * T, 3)
        trans = feats_raw[..., -3:].reshape(B * T, 3)
        joints = smpl_joints24(self.smpl, betas.reshape(B * T, -1), pose, glob, trans)
        return joints.reshape(B, T, 24, 3)

    # ---------------------------------------------------------- conditioning
    @torch.no_grad()
    def scene_features(self, scene: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) point cloud -> (B, 512) frozen PointNet features,
        through the fused blocks."""
        return pointnet_forward(self.kernel_operands()[2], scene)

    @torch.no_grad()
    def encode_scene(self, scene: torch.Tensor) -> torch.Tensor:
        return self.output_scene(self.scene_features(scene))[:, None, :]

    @torch.no_grad()
    def _condition_tokens(self, batch: Dict) -> torch.Tensor:
        tokens = []
        if self.use_interactee:
            mu, _ = self.vae.encode(self.actor_features(batch, INTERACTEE))
            tokens.append(mu)
        if self.use_scene:
            tokens.append(self.encode_scene(batch["scene"]))
        return torch.cat(tokens, dim=1)

    @torch.no_grad()
    def encode_conditioning(self, batch: Dict) -> torch.Tensor:
        """Eval-time condition tokens, doubled as [uncond; cond] when
        guidance > 1 (the uncond half from zeroed inputs)."""
        cond = self._condition_tokens(batch)
        if self.cfg.guidance_scale > 1.0:
            zeroed = {k: (torch.zeros_like(v) if k in ("feats", "transl", "scene") else v)
                      for k, v in batch.items()}
            return torch.cat([self._condition_tokens(zeroed), cond], dim=0)
        return cond

    # -------------------------------------------------------------- sampling
    @torch.no_grad()
    def sample_from_cond(self, cond_full: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         z_init: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Reverse diffusion (the fused DDIM kernel, through the entry
        `cfg.fused_variant` names) + VAE decode. z_init
        (B, 1, D) replaces the drawn initial noise. Returns normalized
        features (B, T, nfeats)."""
        cfg = self.cfg
        B = cond_full.shape[0] // (2 if cfg.guidance_scale > 1.0 else 1)
        shape = (B, cfg.latent_dim[0], cfg.latent_dim[-1])
        if z_init is None:
            z_init = torch.randn(shape, generator=generator, device=self.device)
        sd, weights, _ = self.kernel_operands()
        ddim = ddim_fused_grid if cfg.fused_variant == "grid" else ddim_fused
        z = ddim(sd, cond_full.contiguous(),
                 z_init.to(self.device, torch.float32).contiguous(), self.schedule,
                 cfg.num_inference_timesteps, cfg.num_layers, cfg.guidance_scale,
                 weights=weights)
        return self.vae.decode(z, cfg.motion_length)

    @torch.no_grad()
    def eval_fk(self, batch: Dict, feats_rst: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Renorm, SMPL joints of prediction / ground truth / interactee, and
        the global-orientation quaternions of the head-orientation metric."""
        raw_rst = self.renorm(feats_rst)
        raw_ref = self.renorm(self.actor_features(batch, WEARER))
        raw_int = self.renorm(self.actor_features(batch, INTERACTEE))
        betas = batch["betas"][:, WEARER]
        return {
            "feats_rst": feats_rst,
            "joints_rst": self.feats_to_joints(raw_rst, betas),
            "joints_ref": self.feats_to_joints(raw_ref, betas),
            "joints_int": self.feats_to_joints(raw_int, batch["betas"][:, INTERACTEE]),
            "quat_rst": aa_to_quat(raw_rst[..., :3]),
            "quat_ref": aa_to_quat(raw_ref[..., :3]),
        }
