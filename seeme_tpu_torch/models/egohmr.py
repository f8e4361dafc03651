"""EgoHMR: scene-conditioned diffusion-GCN human mesh recovery, its
evaluation path (`seeme_tpu/models/egohmr.py`).

Each of the 24 SMPL joints is conditioned on [image features masked by the
joint's visibility (2048) | scene (512) | translation (128) | camera (the
parts the `with_*` switches keep, 6 as shipped)],
beside the embedded noisy rot6d and the timestep embedding; a modulated GCN
over the skeleton predicts x0 in the normalized 'diffusion'-layout rot6d
space. Sampling runs respaced ancestral DDPM steps over the cosine
schedule; at each step the image-conditioned and the unconditioned (image
block zeroed, or with `only_mask_img_cond=False` the whole condition)
predictions are fused by visibility: visible joints keep the
former, the others the latter (`egohmr.py:263-278`). A final `forward` at
t = 0 gives the pose, the betas (from the unmasked features) and SMPL.

Under a torch profiler `sample` records the port's spans
(`utils/profiling.py`): `encode` (`encode.image`, the ResNet50;
`encode.pointnet`), `sample` (`sample.denoise`, the steps) and `joints` (the
final forward, its SMPL as `joints.fk`); the OpenPose index copy of each
`visibility_mask` counts as `host_sync.visibility_index`.

The scene encoder runs through the fused PointNet kernels on the card, the
reverse process through the GCN kernels (`ops/gcn_fused.py`, 2 x gcn_layers
+ 2 launches a step and for the final prediction); training's forward runs
the eager `nn/gcn.py::ModulatedGCN`. The image and the scene are encoded
once per `sample` call (the JAX package encodes them three times with
identical results); the two predictions of a step run as one GCN pass over
the stacked [cond; scene-only] rows. Module names follow the reference
checkpoint (`backbone.*`, `scene_enc.*`, `transl_enc.layers.*`,
`embed_timestep.time_embed.*`, `input_process.poseEmbedding`,
`diffusion_model.*`, `beta_layer.layers.*`).

Training (`python -m seeme_tpu_torch.train_egohmr`): `training_loss`, the
x0-prediction MSE in the normalized rot6d space plus `compute_loss`'s
geometric terms, through `forward(drop=...)`, whose `mask_cond` zeroes the
image block (or the whole condition) of the samples `drop` marks (each
with probability `cfg.cond_mask_prob`). Its draws
(timesteps, noise, drop mask; `train_draws`) can be handed in, so a test
replays the JAX package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..core.collision import scene_collision_loss
from ..core.rotations import aa_to_rotmat, perspective_projection, rot6d_to_rotmat
from ..core.smpl import SmplModel, smpl_forward
from ..diffusion.schedulers import DiffusionSchedule, respaced_schedule, space_timesteps
from ..nn.gcn import ModulatedGCN, smpl_adjacency
from ..nn.init import init_parameters_
from ..nn.pointnet import ResnetPointnet
from ..nn.resnet import resnet50
from ..ops.gcn_fused import FusedGcn, gcn_fused
from ..ops.pointnet_fused import FusedPointnet
from ..utils.profiling import count, span
from .prohmr import JOINTS_TO_IGN, SCENE_HIDDEN, SMPL_TO_OPENPOSE, cam_features

# OpenPose-25 joint whose confidence gives each SMPL joint's visibility
# (`egohmr.py:119`, pelvis_vis_loosen=False)
OPENPOSE_TO_SMPL = np.array(
    [8, 12, 9, 8, 13, 10, 8, 14, 11, 8, 14, 11, 0, 5, 2, 0, 5, 2, 6, 3, 7, 4, 7, 4])
COND_MASK_PROB = 0.01  # training's image-block drop (`seeme_tpu/models/egohmr.py:52`)
# `compute_loss`'s weight of each geometric term (`seeme_tpu/models/egohmr.py:319-320`)
LOSS_WEIGHTS = {
    "loss_v2v": 0.5, "loss_keypoints_3d": 0.05, "loss_keypoints_3d_full": 0.02,
    "loss_keypoints_2d_full": 0.01, "loss_betas": 0.0005, "loss_body_pose": 0.001,
    "loss_global_orient": 0.001, "loss_pose_6d_ortho": 0.1}


@dataclass(frozen=True)
class EgoHmrConfig:
    """`seeme_tpu/models/egohmr.py:44-71`'s fields and defaults but
    `start_coap_epoch`, which nothing in the JAX package reads;
    `weight_coap_penetration` > 0 adds the capsule penetration loss
    (`core/collision.py`; 0 as shipped)."""

    img_feat_dim: int = 2048
    scene_feat_dim: int = 512
    transl_embed_dim: int = 128
    input_process_dim: int = 512
    timestep_embed_dim: int = 512
    gcn_hid_dim: int = 1024
    gcn_layers: int = 4
    cond_mask_prob: float = COND_MASK_PROB
    # mask_cond zeroes the image block only, or with False the whole condition
    only_mask_img_cond: bool = True
    with_focal_length: bool = True
    with_bbox_info: bool = True
    with_cam_center: bool = True
    fx_norm_coeff: float = 1500.0
    num_train_timesteps: int = 1000
    timestep_respacing: str = "ddim50"
    weight_coap_penetration: float = 0.0

    @property
    def cam_feat_dim(self) -> int:
        return int(self.with_focal_length) + 3 * int(self.with_bbox_info) \
            + 2 * int(self.with_cam_center)

    @property
    def context_dim(self) -> int:
        return self.img_feat_dim + self.scene_feat_dim + self.transl_embed_dim + self.cam_feat_dim

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
        self._fused_gcn = FusedGcn()

    # ------------------------------------------------------------- encoders
    def encode_scene(self, pcd: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) points -> (B, 512) through the fused PointNet blocks."""
        with span("encode.pointnet"):
            return self._fused_scene(self.scene_enc, pcd)

    def encode(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The timestep-independent features: image (B, 2048) and, in the
        conditioning's order, [scene | translation | camera] (B, 646 as shipped)."""
        rest = [self.encode_scene(batch["scene_pcd"]),
                self.transl_enc(batch["smpl_params"]["transl"]), cam_features(batch, self.cfg)]
        with span("encode.image"):
            img = self.backbone(batch["img"])
        return {"img": img, "rest": torch.cat(rest, dim=-1)}

    # ----------------------------------------------------------- conditioning
    def visibility_mask(self, batch: Dict) -> torch.Tensor:
        """(B, 24) visibility of each SMPL joint from the OpenPose 2D
        confidences; the pelvis always visible (`forward:209-213`)."""
        vis = batch["orig_keypoints_2d"][:, :, -1] > 0
        vis[:, 8] = True
        count("host_sync.visibility_index")   # a copy from the host, on the card a wait
        return vis[:, torch.as_tensor(OPENPOSE_TO_SMPL, device=vis.device)]

    def conditioning(self, enc: Dict, vis_mask: torch.Tensor) -> torch.Tensor:
        """(B, 24, context_dim): [image features masked by visibility | rest]
        (`seeme_tpu/models/egohmr.py:221`)."""
        img = enc["img"][:, None, :] * vis_mask[..., None]
        rest = enc["rest"][:, None, :].expand(-1, 24, -1)
        return torch.cat([img, rest], dim=-1)

    def mask_cond(self, cond: torch.Tensor, drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`mask_cond` (`seeme_tpu/models/egohmr.py:233-252`): the image
        block zeroed (with `only_mask_img_cond=False` the whole condition)
        in every sample (the unconditioned branch, `force_mask`), or, given
        the (B,) bool `drop` of training, in the samples it marks."""
        keep = torch.zeros((), dtype=cond.dtype, device=cond.device) if drop is None else \
            (~drop).to(cond.dtype)[:, None, None]
        if not self.cfg.only_mask_img_cond:
            return cond * keep
        img = cond[:, :, :self.cfg.img_feat_dim]
        return torch.cat([img * keep, cond[:, :, self.cfg.img_feat_dim:]], dim=-1)

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

    def forward(self, batch: Dict, x_t: torch.Tensor, timesteps: torch.Tensor,
                eval_with_uncond: bool = False, enc: Optional[Dict] = None,
                drop: Optional[torch.Tensor] = None,
                pred_x0: Optional[torch.Tensor] = None) -> Dict:
        """One evaluation of the denoiser and SMPL (`seeme_tpu/models/egohmr.py:268`);
        `enc` reuses `encode(batch)`; `drop` (B,) bool is training's
        condition drop (`mask_cond`); `pred_x0` (B, 144), a prediction
        already made (`sample`'s), takes the denoiser's place. Gradients flow
        unless grad mode is off."""
        B = x_t.shape[0]
        enc = self.encode(batch) if enc is None else enc
        vis_mask = self.visibility_mask(batch)
        if pred_x0 is None:
            cond = self.conditioning(enc, vis_mask)
            if drop is not None:
                cond = self.mask_cond(cond, drop)
            if eval_with_uncond:
                vis6 = vis_mask.repeat_interleave(6, dim=-1)
                pred_x0 = self._fused_x0(cond, self.mask_cond(cond), vis6, x_t, timesteps)
            else:
                pred_x0 = self.denoise(cond, x_t, timesteps)
        pose_6d = pred_x0 * self.body_rep_std + self.body_rep_mean
        rotmats = rot6d_to_rotmat(pose_6d.reshape(-1, 6), mode="diffusion").reshape(B, 24, 3, 3)
        # betas from the unmasked image, scene, translation and camera features
        betas = self.beta_layer(torch.cat([enc["img"], enc["rest"]], dim=-1)) + self.init_betas
        with span("joints.fk"):
            smpl_out = smpl_forward(self.smpl, betas, rotmats[:, 1:], rotmats[:, :1],
                                    pose2rot=False)
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

    # --------------------------------------------------------------- training
    def compute_loss(self, batch: Dict, out: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The geometric losses on the predicted x0 (`seeme_tpu/models/egohmr.py:317-405`):
        pelvis-aligned and full 3D keypoints, full-image 2D keypoints in the
        OpenPose order (joints 1, 9, 12 skipped), v2v, the SMPL parameters'
        squared error, the orthogonality of the 'diffusion' rot6d columns,
        and the capsule penetration when `weight_coap_penetration` > 0."""
        sp = batch["smpl_params"]
        B = out["pred_pose_6d"].shape[0]
        k3d = out["pred_keypoints_3d"][:, :24]
        gt_k3d = batch["keypoints_3d"][..., :3]
        l_kp3d = ((k3d - k3d[:, :1]) - (gt_k3d - gt_k3d[:, :1])).abs().sum(dim=(1, 2)).mean()
        k3d_full = out["pred_keypoints_3d_full"][:, :24]
        l_kp3d_full = (k3d_full - batch["keypoints_3d_full"][..., :3]).abs().sum(dim=(1, 2)).mean()

        if self.cfg.with_focal_length:
            focal = (batch["fx"] * self.cfg.fx_norm_coeff)[:, None].expand(B, 2)
            center = torch.stack([batch["cam_cx"], batch["cam_cy"]], dim=-1)
        else:  # the fixed camera (`seeme_tpu/models/egohmr.py:349-355`)
            focal = batch["fx"].new_full((B, 2), 5000.0)
            center = batch["fx"].new_tensor([960.0, 540.0]).expand(B, 2)
        k2d = perspective_projection(out["pred_keypoints_3d"], sp["transl"], focal, center)
        k2d = k2d / k2d.new_tensor([1920.0, 1080.0]) - 0.5
        k2d = k2d[:, torch.as_tensor(SMPL_TO_OPENPOSE, device=k2d.device)]
        gt_k2d = batch["orig_keypoints_2d"]
        conf = gt_k2d[..., -1:].clone()
        conf[:, torch.as_tensor(JOINTS_TO_IGN, device=conf.device)] = 0.0
        l_kp2d_full = (conf * (k2d - gt_k2d[..., :2]).abs()).sum(dim=(1, 2)).mean()

        gt = smpl_forward(self.smpl, sp["betas"], sp["body_pose"], sp["global_orient"])
        l_v2v = ((out["pred_vertices"] - k3d[:, :1])
                 - (gt["vertices"] - gt["joints"][:, :1])).abs().mean()

        psp = out["pred_smpl_params"]
        l_go = ((psp["global_orient"] - aa_to_rotmat(sp["global_orient"]).reshape(B, 1, 3, 3))
                ** 2).sum() / B
        l_bp = ((psp["body_pose"] - aa_to_rotmat(sp["body_pose"].reshape(B, 23, 3))) ** 2).sum() / B
        l_bt = ((psp["betas"] - sp["betas"]) ** 2).sum() / B

        p6 = out["pred_pose_6d"].reshape(-1, 3, 2)
        gram = p6.transpose(1, 2) @ p6
        l_ortho = ((gram - torch.eye(2, device=gram.device)) ** 2).mean()

        terms = {"loss_v2v": l_v2v, "loss_keypoints_3d": l_kp3d,
                 "loss_keypoints_3d_full": l_kp3d_full, "loss_keypoints_2d_full": l_kp2d_full,
                 "loss_betas": l_bt, "loss_body_pose": l_bp, "loss_global_orient": l_go,
                 "loss_pose_6d_ortho": l_ortho}
        total = sum(LOSS_WEIGHTS[k] * v for k, v in terms.items())
        w_coll = self.cfg.weight_coap_penetration
        if w_coll > 0:
            l_coll = scene_collision_loss(batch["scene_pcd"], k3d_full)
            total = total + w_coll * l_coll
            terms["loss_coap_penetration"] = l_coll
        return total, terms

    def train_draws(self, batch_size: int, generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
        """One training step's draws: timesteps (B,) in [0, T), noise (B, 144)
        and the condition drop (B,) bool with probability `cfg.cond_mask_prob`."""
        dev = self.device
        return {"t": torch.randint(0, self.schedule.num_train_timesteps, (batch_size,),
                                   generator=generator, device=dev),
                "noise": torch.randn(batch_size, 144, generator=generator, device=dev),
                "drop": torch.rand(batch_size, generator=generator, device=dev)
                < self.cfg.cond_mask_prob}

    def training_loss(self, batch: Dict, draws: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """`training_loss` (`seeme_tpu/models/egohmr.py:407-430`): x_t from
        `batch["body_rep"]` (B, 144) at `draws["t"]` with `draws["noise"]`, the
        training forward with `draws["drop"]`, the x0 MSE, and the geometric
        losses."""
        x0 = batch["body_rep"]
        t = draws["t"]
        out = self.forward(batch, self.schedule.add_noise(x0, draws["noise"], t), t,
                           drop=draws["drop"])
        mse = ((out["pred_x_start"] - x0) ** 2).mean()
        geo, terms = self.compute_loss(batch, out)
        terms = {"diffusion_mse": mse, **terms, "total": mse + geo}
        return terms["total"], terms

    @torch.no_grad()
    def sample(self, batch: Dict, generator: Optional[torch.Generator] = None,
               x_init: Optional[torch.Tensor] = None,
               noise: Optional[Sequence[torch.Tensor]] = None) -> Dict:
        """Respaced ancestral sampling with x0 prediction, fused by
        visibility at every step, then `forward` at t = 0
        (`seeme_tpu/models/egohmr.py:432-471`). `x_init` (B, 144) and
        `noise[i]` (B, 144), the noise of the i-th step (timestep S-1-i of
        the S respaced ones; the last, t = 0, adds none), replace draws from
        `generator`. The steps and the final prediction run through
        `ops/gcn_fused.py`: on the card its kernels, on the CPU the eager
        module and `ddpm_step`."""
        B = batch["img"].shape[0]
        S = self.sample_schedule.num_train_timesteps
        with span("encode"):
            enc = self.encode(batch)
        dev = self.device

        def draw():
            return torch.randn(B, 144, generator=generator, device=dev)

        with span("sample"):
            vis_mask = self.visibility_mask(batch)
            x = draw() if x_init is None else x_init
            with span("sample.denoise"):
                reverse = self._fused_gcn.batch(self, enc, vis_mask)
                for i, t in enumerate(range(S - 1, -1, -1)):
                    eps = (noise[i] if noise is not None else draw()) if t > 0 else None
                    x = gcn_fused(reverse, x, t, eps)
        final_t = torch.zeros(B, dtype=torch.long, device=dev)
        with span("joints"):
            return self.forward(batch, x, final_t, eval_with_uncond=True, enc=enc,
                                pred_x0=gcn_fused(reverse, x))
