"""Text-to-motion metrics (`seeme_tpu/eval/t2m_metrics.py`): R-precision,
matching score, FID, Diversity, MultiModality, and MPJPE / PA-MPJPE /
ACCEL.

Host-side numpy accumulators, as in the JAX package: the embeddings are
small (N, 512) matrices, computed on once per replication. The helpers are
the reference's `metrics/utils.py` (`euclidean_distance_matrix`,
`calculate_top_k`, activation statistics, the Frechet distance through
scipy's `sqrtm`, diversity, multimodality); `TM2TMetrics` shuffles the
embeddings with a seeded numpy permutation (or a given one) and scores
retrieval in pools of 32, `MMMetrics` scores the spread of repeated
samples of one caption.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import scipy.linalg


def euclidean_distance_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, D) x (M, D) -> (N, M) pairwise L2."""
    d2 = np.sum(a**2, axis=1)[:, None] - 2 * a @ b.T + np.sum(b**2, axis=1)[None]
    return np.sqrt(np.maximum(d2, 0.0))


def calculate_top_k(argsort_mat: np.ndarray, top_k: int) -> np.ndarray:
    """(N, N) argsorted distance rows -> (N, top_k) cumulative hit mask."""
    gt = np.arange(argsort_mat.shape[0])[:, None]
    return np.cumsum(argsort_mat[:, :top_k] == gt, axis=1) > 0


def activation_statistics(act: np.ndarray):
    return act.mean(axis=0), np.cov(act, rowvar=False)


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """FID between two Gaussians (`calculate_frechet_distance_np`)."""
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(cov1.dot(cov2))
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((cov1 + offset).dot(cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(cov1) + np.trace(cov2) - 2 * np.trace(covmean))


def diversity(act: np.ndarray, times: int, seed: int = 0) -> float:
    rng = np.random.RandomState(seed)
    n = act.shape[0]
    i1 = rng.choice(n, times, replace=False)
    i2 = rng.choice(n, times, replace=False)
    return float(np.linalg.norm(act[i1] - act[i2], axis=1).mean())


def multimodality(act: np.ndarray, times: int, seed: int = 0) -> float:
    """(N, repeats, D) embeddings of repeated samples -> mean distance
    between random pairs of one sample's repeats."""
    rng = np.random.RandomState(seed)
    reps = act.shape[1]
    i1 = rng.choice(reps, times)
    i2 = rng.choice(reps, times)
    return float(np.linalg.norm(act[:, i1] - act[:, i2], axis=2).mean())


@dataclass
class TM2TMetrics:
    """R-precision / matching / FID / diversity (`tm2t.py:11-178`):
    embeddings kept per batch, scored once over a shuffle, in retrieval
    pools of `R_size`. `shuffle_idx` replaces the seeded permutation."""

    top_k: int = 3
    R_size: int = 32
    diversity_times: int = 300
    seed: int = 1234
    shuffle_idx: Optional[np.ndarray] = None
    text_embeddings: List[np.ndarray] = field(default_factory=list)
    recmotion_embeddings: List[np.ndarray] = field(default_factory=list)
    gtmotion_embeddings: List[np.ndarray] = field(default_factory=list)

    def update(self, text_emb, rec_emb, gt_emb) -> None:
        for store, emb in ((self.text_embeddings, text_emb), (self.recmotion_embeddings, rec_emb),
                           (self.gtmotion_embeddings, gt_emb)):
            store.append(np.asarray(emb).reshape(len(emb), -1))

    def compute(self) -> Dict[str, float]:
        texts = np.concatenate(self.text_embeddings)
        gen = np.concatenate(self.recmotion_embeddings)
        gt = np.concatenate(self.gtmotion_embeddings)
        n = len(texts)
        if self.shuffle_idx is not None:
            shuffle = np.asarray(self.shuffle_idx)
            assert shuffle.shape == (n,), (shuffle.shape, n)
        else:
            shuffle = np.random.RandomState(self.seed).permutation(n)
        texts, gen, gt = texts[shuffle], gen[shuffle], gt[shuffle]
        assert n >= self.R_size, f"need >= {self.R_size} sequences, got {n}"
        metrics: Dict[str, float] = {}
        for name, motions in (("", gen), ("gt_", gt)):
            top_k_mat = np.zeros(self.top_k)
            matching = 0.0
            groups = n // self.R_size
            for i in range(groups):
                sl = slice(i * self.R_size, (i + 1) * self.R_size)
                dist = np.nan_to_num(euclidean_distance_matrix(texts[sl], motions[sl]))
                matching += np.trace(dist)
                top_k_mat += calculate_top_k(np.argsort(dist, axis=1), self.top_k).sum(0)
            count = groups * self.R_size
            metrics[f"{name}Matching_score"] = matching / count
            for k in range(self.top_k):
                metrics[f"{name}R_precision_top_{k + 1}"] = top_k_mat[k] / count
        mu, cov = activation_statistics(gen)
        gt_mu, gt_cov = activation_statistics(gt)
        metrics["FID"] = frechet_distance(gt_mu, gt_cov, mu, cov)
        dt = min(self.diversity_times, n - 1)
        metrics["Diversity"] = diversity(gen, dt, self.seed)
        metrics["gt_Diversity"] = diversity(gt, dt, self.seed)
        return metrics


@dataclass
class MMMetrics:
    """MultiModality (`metrics/mm.py:11`)."""

    mm_num_times: int = 10
    seed: int = 1234
    mm_embeddings: List[np.ndarray] = field(default_factory=list)

    def update(self, mm_emb) -> None:
        """(B, repeats, D)."""
        self.mm_embeddings.append(np.asarray(mm_emb))

    def compute(self) -> Dict[str, float]:
        act = np.concatenate(self.mm_embeddings)
        return {"MultiModality": multimodality(act, self.mm_num_times, self.seed)}


def procrustes_align(S1: np.ndarray, S2: np.ndarray) -> np.ndarray:
    """Similarity transform of S1 (N, 3) onto S2 — the PA of PA-MPJPE."""
    mu1, mu2 = S1.mean(0), S2.mean(0)
    X1, X2 = S1 - mu1, S2 - mu2
    var1 = (X1**2).sum()
    K = X1.T @ X2
    U, _, Vh = np.linalg.svd(K)
    Z = np.eye(3)
    Z[-1, -1] = np.sign(np.linalg.det(U @ Vh))
    R = Vh.T @ Z @ U.T
    scale = np.trace(R @ K) / var1
    t = mu2 - scale * R @ mu1
    return scale * S1 @ R.T + t


@dataclass
class MRMetrics:
    force_in_meter: bool = True
    sums: Dict[str, float] = field(default_factory=dict)
    count: int = 0

    def update(self, joints_pred, joints_gt, lengths) -> None:
        """(B, T, J, 3) predicted and reference joints, (B,) valid lengths."""
        factor = 1000.0 if self.force_in_meter else 1.0
        for b in range(len(joints_pred)):
            L = int(lengths[b])
            p, g = np.asarray(joints_pred[b][:L]), np.asarray(joints_gt[b][:L])
            mpjpe = np.linalg.norm((p - p[:, :1]) - (g - g[:, :1]), axis=-1).mean() * factor
            pa = np.stack([procrustes_align(p[t], g[t]) for t in range(L)])
            pampjpe = np.linalg.norm(pa - g, axis=-1).mean() * factor
            self.sums["MPJPE"] = self.sums.get("MPJPE", 0.0) + mpjpe
            self.sums["PAMPJPE"] = self.sums.get("PAMPJPE", 0.0) + pampjpe
            if L > 2:
                accel_p = p[:-2] - 2 * p[1:-1] + p[2:]
                accel_g = g[:-2] - 2 * g[1:-1] + g[2:]
                accel = np.linalg.norm(accel_p - accel_g, axis=-1).mean() * factor
                self.sums["ACCEL"] = self.sums.get("ACCEL", 0.0) + accel
            self.count += 1

    def compute(self) -> Dict[str, float]:
        return {k: v / max(self.count, 1) for k, v in self.sums.items()}
