"""Training losses (`seeme_tpu/train/losses.py`), as stateless functions
returning (total, dict of unweighted terms).

Weights come from the config LOSS block as in the reference: LAMBDA_REC
(recons_feature), LAMBDA_JOINT (recons_joints), LAMBDA_ROOT
(recons_transl), LAMBDA_KL (kl_motion); the diffusion noise MSE has weight 1
(`mld/models/losses/mld.py:70-102`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.SmoothL1Loss(reduction='mean'), beta=1."""
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def kl_standard_normal(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """mean KL(N(mu, sigma) || N(0, 1)), as
    `torch.distributions.kl_divergence(...).mean()` (`losses/mld.py:178-188`)."""
    return torch.mean(0.5 * (mu**2 + torch.exp(logvar) - logvar - 1.0))


@dataclass(frozen=True)
class LossWeights:
    lambda_rec: float = 1.0
    lambda_joint: float = 1.0
    lambda_root: float = 1.0
    lambda_kl: float = 1.0e-4


def vae_losses(
    feats_rst: torch.Tensor,
    feats_ref: torch.Tensor,
    joints_rst: torch.Tensor,
    joints_ref: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    weights: LossWeights,
    predict_transl: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stage-1 VAE loss (`losses/mld.py:113-128`).

    joints are (B, T, J, 3); with predict_transl the pelvis (joint 0) is
    compared separately and the joint loss is pelvis-aligned
    (`align_root`, :104-111).
    """
    terms: Dict[str, torch.Tensor] = {}
    total = 0.0
    if predict_transl:
        pelvis_ref = joints_ref[:, :, :1]
        pelvis_rst = joints_rst[:, :, :1]
        joints_ref = joints_ref - pelvis_ref
        joints_rst = joints_rst - pelvis_rst
        terms["recons_transl"] = smooth_l1(pelvis_rst, pelvis_ref)
        total += weights.lambda_root * terms["recons_transl"]
    terms["recons_feature"] = smooth_l1(feats_rst, feats_ref)
    total += weights.lambda_rec * terms["recons_feature"]
    terms["recons_joints"] = smooth_l1(joints_rst, joints_ref)
    total += weights.lambda_joint * terms["recons_joints"]
    terms["kl_motion"] = kl_standard_normal(mu, logvar)
    total += weights.lambda_kl * terms["kl_motion"]
    terms["total"] = total
    return total, terms


def diffusion_losses(
    noise_pred: torch.Tensor, noise: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stage-2 noise-prediction MSE (`losses/mld.py:130-138`, predict_epsilon)."""
    loss = mse(noise_pred, noise)
    return loss, {"inst_loss": loss, "total": loss}


def x0_losses(
    pred: torch.Tensor, latent: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x0-prediction variant (PREDICT_EPSILON=False, `losses/mld.py:136-138`)."""
    loss = mse(pred, latent)
    return loss, {"x_loss": loss, "total": loss}
