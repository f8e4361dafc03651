"""ProHMR-Scene: scene-conditioned probabilistic human mesh recovery, its
evaluation path (`seeme_tpu/models/prohmr.py`).

The context is [cam_center / fx (2) | bbox / fx (3) | fx (1) | ResNet50
image features (2048) | PointNet scene features (512)], in the reference's
prepend order (`prohmr_scene.py:119-138`); a conditional Glow over the
24-joint 'prohmr'-layout rot6d pose (144-d) and an FC head that predicts
the betas and camera offsets from it. The mode (z = 0) comes first, then
`num_test_samples - 1` draws; SMPL and the cameras follow.

The scene encoder is `ResnetPointnet(512, hidden_dim=256)`, encoded
through the fused PointNet kernels (`ops/pointnet_fused.py`) on the card,
as the JAX package encodes it through its Pallas kernels on the
accelerator. Module names follow the reference checkpoint (`backbone.*`,
`scene_enc.*`, `flow.flow._transform._transforms.*`,
`flow.fc_head.layers.{0,2}`). The discriminator and the losses are
training's and are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from .._device import resolve_device
from ..core.rotations import perspective_projection, rot6d_to_rotmat
from ..core.smpl import SmplModel, smpl_forward
from ..flows.glow import ConditionalGlow, GlowConfig
from ..nn.init import init_parameters_
from ..nn.pointnet import ResnetPointnet
from ..nn.resnet import resnet50
from ..ops.pointnet_fused import FusedPointnet

SCENE_HIDDEN = 256  # the scene encoder's hidden width (`seeme_tpu/models/prohmr.py:153`)
CAM_FEATURES = 6    # cam_center / fx, bbox / fx, fx


@dataclass(frozen=True)
class ProHMRConfig:
    """`seeme_tpu/models/prohmr.py:49`, the fields of the evaluation path."""

    flow_dim: int = 144
    flow_layers: int = 4
    flow_hidden: int = 1024
    flow_depth: int = 2
    context_features: int = 2048
    scene_feat_dim: int = 512
    fc_head_features: int = 1024
    image_size: int = 224
    fx_norm_coeff: float = 1500.0
    num_test_samples: int = 4

    @property
    def total_context(self) -> int:
        """Image, camera (the three `with_*` parts, on in every shipped
        config) and scene features."""
        return self.context_features + CAM_FEATURES + self.scene_feat_dim

    def glow_config(self) -> GlowConfig:
        return GlowConfig(features=self.flow_dim, hidden_features=self.flow_hidden,
                          num_layers=self.flow_layers, num_blocks_per_layer=self.flow_depth,
                          context_features=self.total_context)


class FCHead(nn.Module):
    """Betas and camera offsets (13) from the context (`seeme_tpu/models/prohmr.py:95`)."""

    def __init__(self, in_features: int, num_features: int = 1024):
        super().__init__()
        self.layers = nn.Sequential(nn.Linear(in_features, num_features), nn.ReLU(),
                                    nn.Linear(num_features, 13))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.layers(feats)


class SMPLFlow(nn.Module):
    def __init__(self, cfg: ProHMRConfig):
        super().__init__()
        self.flow = ConditionalGlow(cfg.glow_config())
        self.fc_head = FCHead(cfg.total_context, cfg.fc_head_features)


def cam_features(batch: Dict, fx_norm_coeff: float) -> torch.Tensor:
    """(B, 6) camera context in the reference's prepend order: [cam_center /
    fx | bbox / fx | fx] (`prohmr_scene.py:119-138`, `egohmr.py:197-207`)."""
    orig_fx = batch["fx"] * fx_norm_coeff
    center = batch["box_center"]
    return torch.stack([batch["cam_cx"] / orig_fx, batch["cam_cy"] / orig_fx,
                        center[:, 0] / orig_fx, center[:, 1] / orig_fx,
                        batch["box_size"] / orig_fx, batch["fx"]], dim=-1)


class ProHMRScene(nn.Module):
    def __init__(self, cfg: ProHMRConfig, smpl: SmplModel, device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.backbone = resnet50()
        self.scene_enc = ResnetPointnet(cfg.scene_feat_dim, hidden_dim=SCENE_HIDDEN)
        self.flow = SMPLFlow(cfg)
        init_parameters_(self, torch.Generator().manual_seed(seed))
        self.requires_grad_(False)
        self.eval()
        self.to(dev)
        self.device = dev
        self.smpl = smpl.to(dev)
        # the JAX package's defaults without smpl_mean_params.npz (`fc_head.py:26-31`)
        self.register_buffer("init_betas", torch.zeros(10, device=dev), persistent=False)
        self.register_buffer("init_cam", torch.tensor([0.9, 0.0, 0.0], device=dev),
                             persistent=False)
        self._fused_scene = FusedPointnet()

    # ---------------------------------------------------------------- encoders
    def encode_image(self, img: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) crops -> (B, 2048)."""
        return self.backbone(img)

    def encode_scene(self, pcd: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) points -> (B, 512) through the fused PointNet blocks."""
        return self._fused_scene(self.scene_enc, pcd)

    def conditioning_features(self, batch: Dict) -> torch.Tensor:
        """The (B, total_context) context (`seeme_tpu/models/prohmr.py:188`)."""
        return torch.cat([cam_features(batch, self.cfg.fx_norm_coeff),
                          self.encode_image(batch["img"]), self.encode_scene(batch["scene_pcd"])],
                         dim=-1)

    # ------------------------------------------------------------------- flow
    def flow_forward(self, context: torch.Tensor, num_samples: Optional[int] = None,
                     z: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> Dict:
        """SMPLFlow.forward (`seeme_tpu/models/prohmr.py:210`): `num_samples`
        poses a context row from base noise `z` (B, num_samples, 144), or
        drawn from `generator`; rotations in the 'prohmr' layout; betas and
        camera from the FC head."""
        B = context.shape[0]
        if z is not None:
            num_samples = z.shape[1]
        samples, log_prob, _ = self.flow.flow.sample_and_log_prob(num_samples, context,
                                                                 generator=generator, noise=z)
        pose_6d = samples.reshape(B, num_samples, 24, 6)
        rotmats = rot6d_to_rotmat(pose_6d.reshape(-1, 6), mode="prohmr")
        rotmats = rotmats.reshape(B, num_samples, 24, 3, 3)
        offset = self.flow.fc_head(context).reshape(B, 1, 13).expand(B, num_samples, 13)
        return {
            "global_orient": rotmats[:, :, :1],
            "body_pose": rotmats[:, :, 1:],
            "betas": offset[..., :10] + self.init_betas,
            "cam": offset[..., 10:] + self.init_cam,
            "log_prob": log_prob.reshape(B, num_samples),
            "pose_6d": pose_6d.reshape(B, num_samples, -1),
        }

    def flow_log_prob(self, pose_6d: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """Log-density of (B, 144) 'prohmr' rot6d poses (`seeme_tpu/models/prohmr.py:240`)."""
        return self.flow.flow.log_prob(pose_6d, context)[0]

    # ----------------------------------------------------------- forward step
    @torch.no_grad()
    def forward_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> Dict:
        """`forward_step(train=False)` (`seeme_tpu/models/prohmr.py:255-330`):
        the mode (z = 0), then num_test_samples - 1 draws (base noise `noise`,
        (B, num_test_samples - 1, 144), or drawn from `generator`); SMPL on
        every sample; the crop and full-image cameras; 2D projections."""
        cfg = self.cfg
        NS = cfg.num_test_samples
        context = self.conditioning_features(batch)
        B = context.shape[0]
        out = self.flow_forward(context, z=context.new_zeros(B, 1, cfg.flow_dim))
        if NS > 1:
            rnd = self.flow_forward(context, num_samples=NS - 1, z=noise, generator=generator)
            out = {k: torch.cat([out[k], rnd[k]], dim=1) for k in out}

        smpl_out = smpl_forward(self.smpl, out["betas"].reshape(B * NS, 10),
                                out["body_pose"].reshape(B * NS, 23, 3, 3),
                                out["global_orient"].reshape(B * NS, 1, 3, 3), pose2rot=False)
        out["pred_keypoints_3d"] = smpl_out["joints"].reshape(B, NS, -1, 3)
        out["pred_vertices"] = smpl_out["vertices"].reshape(B, NS, -1, 3)
        out["conditioning_feats"] = context

        # cameras (`prohmr_scene.py:183-231`)
        cam = out["cam"]
        focal = (batch["fx"] * cfg.fx_norm_coeff)[:, None, None].expand(B, NS, 2)
        cam_center = torch.stack([batch["cam_cx"], batch["cam_cy"]], dim=-1)[:, None]
        cam_center = cam_center.expand(B, NS, 2)
        s, tx, ty = cam[..., 0], cam[..., 1], cam[..., 2]
        out["pred_cam_t"] = torch.stack(
            [tx, ty, 2 * focal[..., 0] / (cfg.image_size * s + 1e-9)], dim=-1)
        # the full-image camera (convert_pare_to_full_img_cam, `utils/geometry.py:119-131`)
        bbox_h = batch["box_size"][:, None]
        tz = 2 * focal[..., 0] / (bbox_h / cfg.image_size * cfg.image_size * s)
        img_w, img_h = cam_center[..., 0] * 2, cam_center[..., 1] * 2
        cx = 2 * (batch["box_center"][:, None, 0] - img_w / 2) / (s * bbox_h)
        cy = 2 * (batch["box_center"][:, None, 1] - img_h / 2) / (s * bbox_h)
        cam_t_full = torch.stack([tx + cx, ty + cy, tz], dim=-1)
        out["pred_cam_t_full"] = cam_t_full
        k3d = out["pred_keypoints_3d"]
        out["pred_keypoints_3d_full"] = k3d + cam_t_full[:, :, None, :]

        k3d_flat = k3d.reshape(B * NS, -1, 3)
        k2d_full = perspective_projection(k3d_flat, cam_t_full.reshape(B * NS, 3),
                                          focal.reshape(B * NS, 2), cam_center.reshape(B * NS, 2))
        k2d_full = k2d_full / k2d_full.new_tensor([1920.0, 1080.0]) - 0.5
        out["pred_keypoints_2d_full"] = k2d_full.reshape(B, NS, -1, 2)
        k2d = perspective_projection(k3d_flat, out["pred_cam_t"].reshape(B * NS, 3),
                                     focal.reshape(B * NS, 2))
        out["pred_keypoints_2d"] = (k2d / cfg.image_size).reshape(B, NS, -1, 2)
        return out
