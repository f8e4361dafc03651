"""ProHMR-Scene: scene-conditioned probabilistic human mesh recovery, its
evaluation path (`seeme_tpu/models/prohmr.py`).

The context is [cam_center / fx (2) | bbox / fx (3) | fx (1) | ResNet50
image features (2048) | PointNet scene features (512)], in the reference's
prepend order (`prohmr_scene.py:119-138`), each camera part there only
under its `with_*` switch (all on as shipped; without `with_focal_length`
the cameras take the fixed `focal_length` and the 1920 x 1080 image's
centre, `seeme_tpu/models/prohmr.py:285-292`); a conditional Glow over the
24-joint 'prohmr'-layout rot6d pose (144-d) and an FC head that predicts
the betas and camera offsets from it. The mode (z = 0) comes first, then
`num_test_samples - 1` draws; SMPL and the cameras follow.

The scene encoder is `ResnetPointnet(512, hidden_dim=256)`, encoded
through the fused PointNet kernels (`ops/pointnet_fused.py`) on the card,
as the JAX package encodes it through its Pallas kernels on the
accelerator. Module names follow the reference checkpoint (`backbone.*`,
`scene_enc.*`, `flow.flow._transform._transforms.*`,
`flow.fc_head.layers.{0,2}`, `discriminator.*`).

Training (`python -m seeme_tpu_torch.train_prohmr_scene`): `forward_step(train=True)`
takes the mode and `num_train_samples - 1` draws with gradients,
`compute_loss` the keypoint, v2v, NLL, orthogonality and parameter terms
(weighted by `cfg.loss_weights`; the v2v term's ground-truth mesh from
`smpl_male` / `smpl_female`, each the neutral body where it is not given,
by `batch["gender"]`), and the HMR `Discriminator` the adversarial ones. The scene encoder trains
through the fused kernels' backward (`ops/pointnet_fused.py`). Every random
draw of a step (`train_draws`) can be handed in, so a test replays the JAX
package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..core.rotations import aa_to_rotmat, perspective_projection, rot6d_to_rotmat, rotmat_to_rot6d
from ..core.smpl import SmplModel, smpl_forward
from ..flows.glow import ConditionalGlow, GlowConfig
from ..nn.init import init_parameters_
from ..nn.pointnet import ResnetPointnet
from ..nn.resnet import resnet50
from ..ops.pointnet_fused import FusedPointnet

SCENE_HIDDEN = 256  # the scene encoder's hidden width (`seeme_tpu/models/prohmr.py:153`)
# SMPL-45 -> OpenPose-25 joints (`prohmr_scene.py:67-68`)
SMPL_TO_OPENPOSE = np.array(
    [24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
     25, 26, 27, 28, 29, 30, 31, 32, 33, 34])
JOINTS_TO_IGN = np.array([1, 9, 12])  # 2D joints the keypoint losses skip (`prohmr_scene.py:267`)
GENERATOR = ("backbone", "scene_enc", "flow")  # what the G step trains (`train_prohmr_scene.py:91`)


# the training losses' weights (`seeme_tpu/models/prohmr.py:66-76`)
LOSS_WEIGHTS = {
    "V2V_EXP": 0.0, "V2V_MODE": 0.5,
    "KEYPOINTS_3D_EXP": 0.0, "KEYPOINTS_3D_MODE": 0.05,
    "KEYPOINTS_3D_FULL_EXP": 0.0, "KEYPOINTS_3D_FULL_MODE": 0.02,
    "KEYPOINTS_2D_EXP": 0.001, "KEYPOINTS_2D_MODE": 0.01,
    "KEYPOINTS_2D_FULL_EXP": 0.001, "KEYPOINTS_2D_FULL_MODE": 0.01,
    "GLOBAL_ORIENT_EXP": 0.0, "GLOBAL_ORIENT_MODE": 0.001,
    "BODY_POSE_EXP": 0.0, "BODY_POSE_MODE": 0.001,
    "ORTHOGONAL": 0.1, "BETAS_EXP": 0.0, "BETAS_MODE": 0.0005,
    "NLL": 0.001, "ADVERSARIAL": 0.0005,
}
SMPL_PARAM_NOISE_RATIO = 0.005  # the NLL's pose noise (`seeme_tpu/models/prohmr.py:65`)


@dataclass(frozen=True)
class ProHMRConfig:
    """`seeme_tpu/models/prohmr.py:49-82`'s fields and defaults, and the
    glow's `use_batch_norm` (`seeme_tpu/flows/glow.py:49`, which the JAX
    config leaves at its default, on)."""

    flow_dim: int = 144
    flow_layers: int = 4
    flow_hidden: int = 1024
    flow_depth: int = 2
    context_features: int = 2048
    scene_feat_dim: int = 512
    with_focal_length: bool = True
    with_bbox_info: bool = True
    with_cam_center: bool = True
    fc_head_features: int = 1024
    image_size: int = 224
    fx_norm_coeff: float = 1500.0
    focal_length: float = 5000.0  # the cameras' focal length without with_focal_length
    num_train_samples: int = 2
    num_test_samples: int = 4
    smpl_param_noise_ratio: float = SMPL_PARAM_NOISE_RATIO
    loss_weights: Dict[str, float] = field(default_factory=lambda: dict(LOSS_WEIGHTS))
    use_batch_norm: bool = True

    @property
    def cam_feat_dim(self) -> int:
        return int(self.with_focal_length) + 3 * int(self.with_bbox_info) \
            + 2 * int(self.with_cam_center)

    @property
    def total_context(self) -> int:
        """Image, camera (the parts the `with_*` switches keep) and scene features."""
        return self.context_features + self.cam_feat_dim + self.scene_feat_dim

    def glow_config(self) -> GlowConfig:
        return GlowConfig(features=self.flow_dim, hidden_features=self.flow_hidden,
                          num_layers=self.flow_layers, num_blocks_per_layer=self.flow_depth,
                          context_features=self.total_context,
                          use_batch_norm=self.use_batch_norm)


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


class Discriminator(nn.Module):
    """The HMR pose and shape discriminator -> (B, 25)
    (`seeme_tpu/models/prohmr.py:109-135`), in the reference's layout
    (`discriminator.py:4-97`): 1x1 convolutions over each joint's rotation
    matrix, a scalar head per joint (`pose_out.{j}`), a betas MLP, and an MLP
    over all joints, whose input is the reference's channel-major flattening
    (channel c of joint j at c * 23 + j)."""

    def __init__(self, num_joints: int = 23):
        super().__init__()
        self.num_joints = num_joints
        self.D_conv1 = nn.Conv2d(9, 32, 1)
        self.D_conv2 = nn.Conv2d(32, 32, 1)
        self.pose_out = nn.ModuleList([nn.Linear(32, 1) for _ in range(num_joints)])
        self.betas_fc1 = nn.Linear(10, 10)
        self.betas_fc2 = nn.Linear(10, 5)
        self.betas_out = nn.Linear(5, 1)
        self.D_alljoints_fc1 = nn.Linear(32 * num_joints, 1024)
        self.D_alljoints_fc2 = nn.Linear(1024, 1024)
        self.D_alljoints_out = nn.Linear(1024, 1)

    def forward(self, poses: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
        """(B, 23, 3, 3) body-pose rotations and (B, 10) betas."""
        B = poses.shape[0]
        p = poses.reshape(B, self.num_joints, 9)
        for conv in (self.D_conv1, self.D_conv2):
            p = F.relu(F.linear(p, conv.weight.flatten(1), conv.bias))  # (B, J, 32)
        w = torch.cat([head.weight for head in self.pose_out])
        b = torch.cat([head.bias for head in self.pose_out])
        poses_out = (p * w).sum(-1) + b
        h = F.relu(self.betas_fc2(F.relu(self.betas_fc1(betas))))
        a = p.transpose(1, 2).reshape(B, -1)
        a = F.relu(self.D_alljoints_fc2(F.relu(self.D_alljoints_fc1(a))))
        return torch.cat([poses_out, self.betas_out(h), self.D_alljoints_out(a)], dim=1)


def gt_pose_6d(smpl_params: Dict) -> torch.Tensor:
    """(B, 144) 'prohmr' rot6d of the ground-truth global orient and body
    pose (`seeme_tpu/models/prohmr.py:421-427`)."""
    B = smpl_params["betas"].shape[0]
    rot = aa_to_rotmat(torch.cat([smpl_params["global_orient"].reshape(B, 1, 3),
                                  smpl_params["body_pose"].reshape(B, 23, 3)], dim=1))
    return rotmat_to_rot6d(rot, "prohmr").reshape(B, -1)


def cam_features(batch: Dict, cfg) -> torch.Tensor:
    """(B, cfg.cam_feat_dim) camera context in the reference's prepend order:
    [cam_center / fx | bbox / fx | fx], each part only under its `with_*`
    switch of `cfg` (`prohmr_scene.py:119-138`, `egohmr.py:197-207`)."""
    orig_fx = batch["fx"] * cfg.fx_norm_coeff
    center = batch["box_center"]
    parts = []
    if cfg.with_cam_center:
        parts += [batch["cam_cx"] / orig_fx, batch["cam_cy"] / orig_fx]
    if cfg.with_bbox_info:
        parts += [center[:, 0] / orig_fx, center[:, 1] / orig_fx, batch["box_size"] / orig_fx]
    if cfg.with_focal_length:
        parts.append(batch["fx"])
    if not parts:
        return batch["fx"].new_zeros(batch["fx"].shape[0], 0)
    return torch.stack(parts, dim=-1)


class ProHMRScene(nn.Module):
    def __init__(self, cfg: ProHMRConfig, smpl: SmplModel, device: str | torch.device = "cuda",
                 seed: int = 0, smpl_male: Optional[SmplModel] = None,
                 smpl_female: Optional[SmplModel] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.backbone = resnet50()
        self.scene_enc = ResnetPointnet(cfg.scene_feat_dim, hidden_dim=SCENE_HIDDEN)
        self.flow = SMPLFlow(cfg)
        self.discriminator = Discriminator()
        init_parameters_(self, torch.Generator().manual_seed(seed))
        self.requires_grad_(False)
        self.eval()
        self.to(dev)
        self.device = dev
        self.smpl = smpl.to(dev)
        # the ground truth's gendered bodies of the v2v term (`seeme_tpu/models/prohmr.py:
        # 144-151`); None: `self.smpl`, the neutral body
        self.smpl_male = None if smpl_male is None else smpl_male.to(dev)
        self.smpl_female = None if smpl_female is None else smpl_female.to(dev)
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
        return torch.cat([cam_features(batch, self.cfg), self.encode_image(batch["img"]),
                          self.encode_scene(batch["scene_pcd"])], dim=-1)

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

    @torch.no_grad()
    def initialize_actnorm(self, pose_6d: torch.Tensor, context: torch.Tensor) -> None:
        """The ActNorm warm-up on one batch (`seeme_tpu/models/prohmr.py:247-253`)."""
        self.flow.flow.initialize_actnorm(pose_6d, context)

    def train_draws(self, batch_size: int, generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
        """The random draws of one training step: the flow's base noise
        (B, num_train_samples - 1, 144) and the NLL's pose noise (B, 144)."""
        cfg = self.cfg
        draw = lambda *shape: torch.randn(*shape, generator=generator,  # noqa: E731
                                          device=self.device)
        return {"flow": draw(batch_size, cfg.num_train_samples - 1, cfg.flow_dim),
                "nll": draw(batch_size, cfg.flow_dim)}

    # ----------------------------------------------------------- forward step
    def forward_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None, train: bool = False) -> Dict:
        """`forward_step` (`seeme_tpu/models/prohmr.py:255-330`): the mode
        (z = 0), then NS - 1 draws (base noise `noise`, (B, NS - 1, 144), or
        drawn from `generator`), NS = num_train_samples when `train` else
        num_test_samples; SMPL on every sample; the crop and full-image
        cameras; 2D projections. Gradients flow unless grad mode is off."""
        cfg = self.cfg
        NS = cfg.num_train_samples if train else cfg.num_test_samples
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
        if cfg.with_focal_length:
            focal = (batch["fx"] * cfg.fx_norm_coeff)[:, None, None].expand(B, NS, 2)
            cam_center = torch.stack([batch["cam_cx"], batch["cam_cy"]], dim=-1)[:, None]
        else:
            focal = context.new_full((B, NS, 2), cfg.focal_length)
            cam_center = context.new_tensor([960.0, 540.0])[None, None]
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

    # ------------------------------------------------------------------ losses
    def compute_loss(self, batch: Dict, output: Dict, nll_noise: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """`compute_loss` (`seeme_tpu/models/prohmr.py:331-461`): the mode's
        and the draws' (expectation) keypoint, v2v and parameter losses, the
        NLL of the ground-truth pose plus `cfg.smpl_param_noise_ratio` times
        `nll_noise` (B, 144), and the rot6d orthogonality."""
        W = self.cfg.loss_weights
        op = torch.as_tensor(SMPL_TO_OPENPOSE, device=self.device)
        k3d = output["pred_keypoints_3d"][:, :, :24]
        B, NS = k3d.shape[:2]

        def rep(x):
            return x[:, None].expand(B, NS, *x.shape[1:])

        def kp2d_loss(pred, gt):
            conf = gt[..., -1:].clone()
            conf[:, :, JOINTS_TO_IGN] = 0.0
            return (conf * (pred - gt[..., :-1]).abs()).sum(dim=(2, 3))

        def kp3d_loss(pred, gt, pelvis_align):
            gt = gt[..., :3]
            if pelvis_align:
                pred, gt = pred - pred[:, :, :1], gt - gt[:, :, :1]
            return (pred - gt).abs().sum(dim=(2, 3))

        def mode_exp(loss):
            exp = loss[:, 1:].sum() / (B * (NS - 1)) if NS > 1 else 0.0
            return loss[:, 0].sum() / B, exp

        l2d = mode_exp(kp2d_loss(output["pred_keypoints_2d"][:, :, op], rep(batch["keypoints_2d"])))
        l2df = mode_exp(kp2d_loss(output["pred_keypoints_2d_full"][:, :, op],
                                  rep(batch["orig_keypoints_2d"])))
        l3d = mode_exp(kp3d_loss(k3d, rep(batch["keypoints_3d"]), True))
        l3df = mode_exp(kp3d_loss(output["pred_keypoints_3d_full"][:, :, :24],
                                  rep(batch["keypoints_3d_full"]), False))

        # v2v against the ground-truth mesh: the male body's, or the female
        # body's where batch["gender"] is 1 (`seeme_tpu/models/prohmr.py:364-376`)
        sp = batch["smpl_params"]
        male = self.smpl if self.smpl_male is None else self.smpl_male
        female = self.smpl if self.smpl_female is None else self.smpl_female
        gt = smpl_forward(male, sp["betas"], sp["body_pose"], sp["global_orient"])
        if female is not male and "gender" in batch:
            gt_f = smpl_forward(female, sp["betas"], sp["body_pose"], sp["global_orient"])
            is_f = (batch["gender"] == 1)[:, None, None]
            gt = {k: torch.where(is_f, gt_f[k], gt[k]) for k in ("vertices", "joints")}
        l_v2v = ((output["pred_vertices"] - output["pred_keypoints_3d"][:, :, :1])
                 - (gt["vertices"] - gt["joints"][:, :1])[:, None]).abs().mean(dim=(2, 3))
        v2v = (l_v2v[:, 0].mean(), l_v2v[:, 1:].mean() if NS > 1 else 0.0)

        gt_go = aa_to_rotmat(sp["global_orient"]).reshape(B, 1, -1)
        gt_bp = aa_to_rotmat(sp["body_pose"].reshape(B, 23, 3)).reshape(B, 1, -1)
        go = mode_exp(((output["global_orient"].reshape(B, NS, -1) - gt_go) ** 2).sum(-1))
        bp = mode_exp(((output["body_pose"].reshape(B, NS, -1) - gt_bp) ** 2).sum(-1))
        bt = mode_exp(((output["betas"].reshape(B, NS, -1) - sp["betas"][:, None]) ** 2).sum(-1))

        pose = gt_pose_6d(sp) + self.cfg.smpl_param_noise_ratio * nll_noise
        nll = -self.flow_log_prob(pose, output["conditioning_feats"]).mean()

        p6 = output["pose_6d"].reshape(-1, 2, 3)
        gram = p6 @ p6.transpose(1, 2)
        ortho = ((gram - torch.eye(2, device=gram.device)) ** 2).reshape(B, NS, -1)
        ortho_m, ortho_e = ortho[:, 0].mean(), ortho[:, 1:].mean() if NS > 1 else 0.0

        total = (W["KEYPOINTS_3D_EXP"] * l3d[1] + W["KEYPOINTS_3D_MODE"] * l3d[0]
                 + W["KEYPOINTS_3D_FULL_EXP"] * l3df[1] + W["KEYPOINTS_3D_FULL_MODE"] * l3df[0]
                 + W["V2V_EXP"] * v2v[1] + W["V2V_MODE"] * v2v[0]
                 + W["KEYPOINTS_2D_EXP"] * l2d[1] + W["KEYPOINTS_2D_MODE"] * l2d[0]
                 + W["KEYPOINTS_2D_FULL_EXP"] * l2df[1] + W["KEYPOINTS_2D_FULL_MODE"] * l2df[0]
                 + W["NLL"] * nll + W["ORTHOGONAL"] * (ortho_e + ortho_m)
                 + W["GLOBAL_ORIENT_EXP"] * go[1] + W["GLOBAL_ORIENT_MODE"] * go[0]
                 + W["BODY_POSE_EXP"] * bp[1] + W["BODY_POSE_MODE"] * bp[0]
                 + W["BETAS_EXP"] * bt[1] + W["BETAS_MODE"] * bt[0])
        terms = {"loss": total, "loss_nll": nll, "loss_keypoints_3d_mode": l3d[0],
                 "loss_v2v_mode": v2v[0], "loss_keypoints_2d_mode": l2d[0],
                 "loss_pose_6d_mode": ortho_m}
        return total, terms

    def discriminator_outputs(self, body_pose: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
        """(B, 25) discriminator scores (`seeme_tpu/models/prohmr.py:462`)."""
        return self.discriminator(body_pose, betas)
