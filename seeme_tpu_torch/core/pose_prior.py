"""SMPL pose prior for the fitting CLI (`seeme_tpu/core/pose_prior.py`).

The reference's MaxMixturePrior (`mld/transforms/joints2rots/prior.py:98-230`):
a GMM over the 69-d body pose, scored with the max-mixture approximation
    nll(pose) = min_k [ 0.5 (pose - mu_k)^T P_k (pose - mu_k) - log w'_k ]
with w'_k = weights_k / ((2 pi)^(D/2) sqrtdet_k / min_j sqrtdet_j). The GMM
file (`gmm_08.pkl`, a dict or an sklearn GMM) is read when it exists; without
it a single standard-normal component stands in (`.is_fallback`), which is
the L2 pose regularizer up to a constant.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Optional

import numpy as np
import torch

POSE_DIM = 69


class MaxMixturePrior:
    def __init__(self, gmm_path: Optional[str] = None, num_gaussians: int = 8,
                 epsilon: float = 1e-16):
        if gmm_path and os.path.isdir(gmm_path):
            gmm_path = os.path.join(gmm_path, f"gmm_{num_gaussians:02d}.pkl")
        if gmm_path and os.path.exists(gmm_path):
            with open(gmm_path, "rb") as f:
                gmm = pickle.load(f, encoding="latin1")
            if isinstance(gmm, dict):
                means, covs, weights = gmm["means"], gmm["covars"], gmm["weights"]
            else:  # an sklearn GMM
                means, covs, weights = gmm.means_, gmm.covars_, gmm.weights_
            means, covs, weights = (np.asarray(a, np.float64) for a in (means, covs, weights))
            self.is_fallback = False
        else:
            means, covs, weights = np.zeros((1, POSE_DIM)), np.eye(POSE_DIM)[None], np.ones(1)
            self.is_fallback = True
        precisions = np.stack([np.linalg.inv(c) for c in covs])
        sqrdets = np.sqrt(np.maximum(np.array([np.linalg.det(c) for c in covs]), epsilon))
        const = (2 * math.pi) ** (means.shape[1] / 2.0)
        nll_weights = weights / (const * (sqrdets / sqrdets.min()))
        # float32 tables, as the JAX prior's; each call casts them to the pose's dtype
        self.means = torch.as_tensor(means.astype(np.float32))
        self.precisions = torch.as_tensor(precisions.astype(np.float32))
        self.log_nll_weights = torch.as_tensor(np.log(nll_weights).astype(np.float32))

    def __call__(self, pose: torch.Tensor) -> torch.Tensor:
        """(B, 69) body pose -> (B,) max-mixture negative log likelihood."""
        means, prec, logw = (t.to(pose.device, pose.dtype)
                             for t in (self.means, self.precisions, self.log_nll_weights))
        diff = pose[:, None, :] - means[None]                          # (B, K, D)
        quad = (torch.einsum("kij,bkj->bki", prec, diff) * diff).sum(-1)  # (B, K)
        return (0.5 * quad - logw[None]).min(dim=1).values
