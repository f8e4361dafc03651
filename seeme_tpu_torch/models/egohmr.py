"""EgoHMR: scene-conditioned diffusion-GCN human mesh recovery, its
evaluation path (`seeme_tpu/models/egohmr.py`).

Each of the 24 SMPL joints is conditioned on [image features masked by the
joint's visibility (2048) | scene (512) | translation (128) | camera (6)],
beside the embedded noisy rot6d and the timestep embedding; a modulated GCN
over the skeleton predicts x0 in the normalized 'diffusion'-layout rot6d
space. Sampling runs respaced ancestral DDPM steps over the cosine
schedule; at each step the image-conditioned and the scene-only (image block
zeroed) predictions are fused by visibility: visible joints keep the
former, the others the latter (`egohmr.py:263-278`). A final `forward` at
t = 0 gives the pose, the betas (from the unmasked features) and SMPL.

The scene encoder runs through the fused PointNet kernels on the card. The
image and the scene are encoded once per `sample` call (the JAX package
encodes them three times with identical results); the two predictions of a
step run as one GCN call over the stacked [cond; scene-only] rows. Module
names follow the reference checkpoint (`backbone.*`, `scene_enc.*`,
`transl_enc.layers.*`, `embed_timestep.time_embed.*`,
`input_process.poseEmbedding`, `diffusion_model.*`, `beta_layer.layers.*`).
The losses and training are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..core.rotations import rot6d_to_rotmat
from ..core.smpl import SmplModel, smpl_forward
from ..diffusion.schedulers import DiffusionSchedule, respaced_schedule, space_timesteps
from ..nn.gcn import ModulatedGCN, smpl_adjacency
from ..nn.init import init_parameters_
from ..nn.pointnet import ResnetPointnet
from ..nn.resnet import resnet50
from ..ops.pointnet_fused import FusedPointnet
from .prohmr import CAM_FEATURES, SCENE_HIDDEN, cam_features

# OpenPose-25 joint whose confidence gives each SMPL joint's visibility
# (`egohmr.py:119`, pelvis_vis_loosen=False)
OPENPOSE_TO_SMPL = np.array(
    [8, 12, 9, 8, 13, 10, 8, 14, 11, 8, 14, 11, 0, 5, 2, 0, 5, 2, 6, 3, 7, 4, 7, 4])


@dataclass(frozen=True)
class EgoHmrConfig:
    """`seeme_tpu/models/egohmr.py:44`, the fields of the evaluation path."""

    img_feat_dim: int = 2048
    scene_feat_dim: int = 512
    transl_embed_dim: int = 128
    input_process_dim: int = 512
    timestep_embed_dim: int = 512
    gcn_hid_dim: int = 1024
    gcn_layers: int = 4
    fx_norm_coeff: float = 1500.0
    num_train_timesteps: int = 1000
    timestep_respacing: str = "ddim50"

    @property
    def context_dim(self) -> int:
        return self.img_feat_dim + self.scene_feat_dim + self.transl_embed_dim + CAM_FEATURES

    @property
    def gcn_in_dim(self) -> int:
        return self.context_dim + self.input_process_dim + self.timestep_embed_dim


def sinusoidal_table(max_len: int, d: int) -> np.ndarray:
    """The positional-encoding table the timestep embedder indexes
    (`egohmr.py:634-651`)."""
    pe = np.zeros((max_len, d), np.float32)
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * (-math.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class TimestepEmbedder(nn.Module):
    """time_embed(pe[timesteps]) (`seeme_tpu/models/egohmr.py:90`)."""

    def __init__(self, latent_dim: int = 512, max_len: int = 5000):
        super().__init__()
        self.time_embed = nn.Sequential(nn.Linear(latent_dim, latent_dim), nn.SiLU(),
                                        nn.Linear(latent_dim, latent_dim))
        self.register_buffer("pe", torch.as_tensor(sinusoidal_table(max_len, latent_dim)),
                             persistent=False)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.time_embed(self.pe[timesteps])


class MLP(nn.Module):
    """Linear -> ReLU -> Linear as `layers.{0,2}`: TranslEnc (`:105`, 3 -> 64
    -> 128) and FCHeadBeta (`:113`, context -> 1024 -> 10)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int):
        super().__init__()
        self.layers = nn.Sequential(nn.Linear(in_dim, hidden), nn.ReLU(),
                                    nn.Linear(hidden, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class InputProcess(nn.Module):
    def __init__(self, out_dim: int):
        super().__init__()
        self.poseEmbedding = nn.Linear(6, out_dim)


class EgoHmr(nn.Module):
    def __init__(self, cfg: EgoHmrConfig, smpl: SmplModel, device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.backbone = resnet50()
        self.scene_enc = ResnetPointnet(cfg.scene_feat_dim, hidden_dim=SCENE_HIDDEN)
        self.transl_enc = MLP(3, 64, cfg.transl_embed_dim)
        self.embed_timestep = TimestepEmbedder(cfg.timestep_embed_dim)
        self.input_process = InputProcess(cfg.input_process_dim)
        self.diffusion_model = ModulatedGCN(cfg.gcn_in_dim, smpl_adjacency(), cfg.gcn_hid_dim, 6,
                                            cfg.gcn_layers)
        self.beta_layer = MLP(cfg.context_dim, 1024, 10)
        init_parameters_(self, torch.Generator().manual_seed(seed))
        self.requires_grad_(False)
        self.eval()
        self.to(dev)
        self.device = dev
        self.smpl = smpl.to(dev)
        # the JAX package's defaults without the dataset's pose statistics and
        # smpl_mean_params.npz
        for name, value in (("body_rep_mean", torch.zeros(144)), ("body_rep_std", torch.ones(144)),
                            ("init_betas", torch.zeros(10))):
            self.register_buffer(name, value.to(dev), persistent=False)
        # the x0-predicting cosine schedule (`EgoHMR/diffusion/gaussian_diffusion.py`),
        # respaced for sampling
        self.schedule = DiffusionSchedule(num_train_timesteps=cfg.num_train_timesteps,
                                          beta_schedule="squaredcos_cap_v2",
                                          prediction_type="sample")
        self.sample_schedule, self.timestep_map = respaced_schedule(
            self.schedule, space_timesteps(cfg.num_train_timesteps, cfg.timestep_respacing))
        self._fused_scene = FusedPointnet()

    # ------------------------------------------------------------- encoders
    def encode_scene(self, pcd: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) points -> (B, 512) through the fused PointNet blocks."""
        return self._fused_scene(self.scene_enc, pcd)

    def encode(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The timestep-independent features: image (B, 2048) and, in the
        conditioning's order, [scene | translation | camera] (B, 646)."""
        rest = [self.encode_scene(batch["scene_pcd"]),
                self.transl_enc(batch["smpl_params"]["transl"]),
                cam_features(batch, self.cfg.fx_norm_coeff)]
        return {"img": self.backbone(batch["img"]), "rest": torch.cat(rest, dim=-1)}

    # ----------------------------------------------------------- conditioning
    def visibility_mask(self, batch: Dict) -> torch.Tensor:
        """(B, 24) visibility of each SMPL joint from the OpenPose 2D
        confidences; the pelvis always visible (`forward:209-213`)."""
        vis = batch["orig_keypoints_2d"][:, :, -1] > 0
        vis[:, 8] = True
        return vis[:, torch.as_tensor(OPENPOSE_TO_SMPL, device=vis.device)]

    def conditioning(self, enc: Dict, vis_mask: torch.Tensor) -> torch.Tensor:
        """(B, 24, context_dim): [image features masked by visibility | rest]
        (`seeme_tpu/models/egohmr.py:221`)."""
        img = enc["img"][:, None, :] * vis_mask[..., None]
        rest = enc["rest"][:, None, :].expand(-1, 24, -1)
        return torch.cat([img, rest], dim=-1)

    def mask_cond(self, cond: torch.Tensor) -> torch.Tensor:
        """The scene-only condition: `mask_cond(force_mask=True)`
        (`seeme_tpu/models/egohmr.py:233`) with only_mask_img_cond, as
        shipped: the image block zeroed."""
        out = cond.clone()
        out[:, :, :self.cfg.img_feat_dim] = 0.0
        return out

    # ------------------------------------------------------------- denoising
    def denoise(self, cond: torch.Tensor, x_t: torch.Tensor,
                timesteps: torch.Tensor) -> torch.Tensor:
        """(B, 144) noisy normalized rot6d and (B, 24, context) -> predicted
        x0 (`seeme_tpu/models/egohmr.py:256`)."""
        B = x_t.shape[0]
        x_feat = self.input_process.poseEmbedding(x_t.reshape(B, 24, 6))
        t_emb = self.embed_timestep(timesteps)[:, None].expand(-1, 24, -1)
        return self.diffusion_model(torch.cat([cond, x_feat, t_emb], dim=-1)).reshape(B, 144)

    def _fused_x0(self, cond, cond_uncond, vis6, x, timesteps):
        """The visibility-guided fusion of the conditioned and the scene-only
        predictions, both in one GCN call over the stacked rows."""
        both = self.denoise(torch.cat([cond, cond_uncond]), torch.cat([x, x]),
                            torch.cat([timesteps, timesteps]))
        pred, pred_uncond = both.chunk(2)
        return torch.where(vis6, pred, pred_uncond)

    @torch.no_grad()
    def forward(self, batch: Dict, x_t: torch.Tensor, timesteps: torch.Tensor,
                eval_with_uncond: bool = False, enc: Optional[Dict] = None) -> Dict:
        """One evaluation of the denoiser and SMPL (`seeme_tpu/models/egohmr.py:268`,
        train=False); `enc` reuses `encode(batch)`."""
        B = x_t.shape[0]
        enc = self.encode(batch) if enc is None else enc
        vis_mask = self.visibility_mask(batch)
        cond = self.conditioning(enc, vis_mask)
        if eval_with_uncond:
            vis6 = vis_mask.repeat_interleave(6, dim=-1)
            pred_x0 = self._fused_x0(cond, self.mask_cond(cond), vis6, x_t, timesteps)
        else:
            pred_x0 = self.denoise(cond, x_t, timesteps)
        pose_6d = pred_x0 * self.body_rep_std + self.body_rep_mean
        rotmats = rot6d_to_rotmat(pose_6d.reshape(-1, 6), mode="diffusion").reshape(B, 24, 3, 3)
        # betas from the unmasked image, scene, translation and camera features
        betas = self.beta_layer(torch.cat([enc["img"], enc["rest"]], dim=-1)) + self.init_betas
        smpl_out = smpl_forward(self.smpl, betas, rotmats[:, 1:], rotmats[:, :1], pose2rot=False)
        return {
            "pred_x_start": pred_x0,
            "vis_mask_smpl": vis_mask,
            "pred_smpl_params": {"global_orient": rotmats[:, :1], "body_pose": rotmats[:, 1:],
                                 "betas": betas},
            "pred_pose_6d": pose_6d,
            "pred_keypoints_3d": smpl_out["joints"],
            "pred_vertices": smpl_out["vertices"],
            "pred_keypoints_3d_full": smpl_out["joints"] + batch["smpl_params"]["transl"][:, None],
        }

    @torch.no_grad()
    def sample(self, batch: Dict, generator: Optional[torch.Generator] = None,
               x_init: Optional[torch.Tensor] = None,
               noise: Optional[Sequence[torch.Tensor]] = None) -> Dict:
        """Respaced ancestral sampling with x0 prediction, fused by
        visibility at every step, then `forward` at t = 0
        (`seeme_tpu/models/egohmr.py:432-471`). `x_init` (B, 144) and
        `noise[i]` (B, 144), the noise of the i-th step (timestep S-1-i of
        the S respaced ones; the last, t = 0, adds none), replace draws from
        `generator`."""
        B = batch["img"].shape[0]
        sched = self.sample_schedule
        S = sched.num_train_timesteps
        enc = self.encode(batch)
        vis_mask = self.visibility_mask(batch)
        cond = self.conditioning(enc, vis_mask)
        cond_uncond = self.mask_cond(cond)
        vis6 = vis_mask.repeat_interleave(6, dim=-1)
        dev = self.device

        def draw():
            return torch.randn(B, 144, generator=generator, device=dev)

        x = draw() if x_init is None else x_init
        for i, t in enumerate(range(S - 1, -1, -1)):
            model_t = torch.full((B,), int(self.timestep_map[t]), dtype=torch.long, device=dev)
            pred = self._fused_x0(cond, cond_uncond, vis6, x, model_t)
            eps = (noise[i] if noise is not None else draw()) if t > 0 else None
            x = sched.ddpm_step(pred, t, x, eps)
        final_t = torch.zeros(B, dtype=torch.long, device=dev)
        return self.forward(batch, x, final_t, eval_with_uncond=True, enc=enc)
