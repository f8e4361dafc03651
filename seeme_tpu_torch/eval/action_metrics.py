"""Action-to-motion and unconditional-generation metrics
(`seeme_tpu/eval/action_metrics.py`, the reference's `metrics/gru.py`,
`metrics/stgcn.py` and `metrics/uncond.py`): FID, recognition accuracy,
Diversity and MultiModality over the features of an action-recognition
evaluator (`eval/action_classifier.py`, `eval/stgcn.py`).

Host-side numpy accumulators over `eval/t2m_metrics.py`'s activation
statistics and Frechet distance; the pairs are drawn from
`np.random.RandomState(seed)` in the JAX package's order, so both packages
score the same features alike.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from .t2m_metrics import activation_statistics, frechet_distance


def diversity_times(num_per_class: int, num_classes: int) -> int:
    return min(200, num_per_class * num_classes // 2)


def _require(feats: List[np.ndarray], name: str) -> None:
    if not feats:
        raise RuntimeError(f"{name}.compute() with no accumulated batches: the eval loop "
                           "yielded nothing (a test split smaller than the batch size?)")


@dataclass
class ActionMetrics:
    """FID / accuracy / Diversity / MultiModality on recognition features."""

    num_classes: int
    seed: int = 1234
    gen_feats: List[np.ndarray] = field(default_factory=list)
    gt_feats: List[np.ndarray] = field(default_factory=list)
    gen_logits: List[np.ndarray] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)

    def update(self, gen_features, gt_features, gen_logits, labels) -> None:
        self.gen_feats.append(np.asarray(gen_features))
        self.gt_feats.append(np.asarray(gt_features))
        self.gen_logits.append(np.asarray(gen_logits))
        self.labels.append(np.asarray(labels))

    def compute(self) -> Dict[str, float]:
        _require(self.gen_feats, "ActionMetrics")
        gen, gt = np.concatenate(self.gen_feats), np.concatenate(self.gt_feats)
        logits, labels = np.concatenate(self.gen_logits), np.concatenate(self.labels)
        rng = np.random.RandomState(self.seed)
        out = {"accuracy": float((logits.argmax(-1) == labels).mean())}
        out["FID"] = frechet_distance(*activation_statistics(gt), *activation_statistics(gen))
        times = min(200, len(gen) // 2)
        i1 = rng.choice(len(gen), times, replace=False)
        i2 = rng.choice(len(gen), times, replace=False)
        out["Diversity"] = float(np.linalg.norm(gen[i1] - gen[i2], axis=1).mean())
        dists = []  # MultiModality: mean within-class distance
        for c in range(self.num_classes):
            idx = np.where(labels == c)[0]
            if len(idx) < 2:
                continue
            k = min(20, len(idx))
            a, b = gen[rng.choice(idx, k)], gen[rng.choice(idx, k)]
            dists.append(np.linalg.norm(a - b, axis=1).mean())
        if dists:
            out["MultiModality"] = float(np.mean(dists))
        return out

    def reset(self) -> None:
        for lst in (self.gen_feats, self.gt_feats, self.gen_logits, self.labels):
            lst.clear()


@dataclass
class UncondMetrics:
    """Unconditional-generation FID and Diversity (generated and real)."""

    seed: int = 1234
    gen_feats: List[np.ndarray] = field(default_factory=list)
    gt_feats: List[np.ndarray] = field(default_factory=list)

    def update(self, gen_features, gt_features) -> None:
        self.gen_feats.append(np.asarray(gen_features))
        self.gt_feats.append(np.asarray(gt_features))

    def compute(self) -> Dict[str, float]:
        _require(self.gen_feats, "UncondMetrics")
        gen, gt = np.concatenate(self.gen_feats), np.concatenate(self.gt_feats)
        rng = np.random.RandomState(self.seed)
        times = min(300, len(gen) // 2)
        i1 = rng.choice(len(gen), times, replace=False)
        i2 = rng.choice(len(gen), times, replace=False)
        return {
            "FID": frechet_distance(*activation_statistics(gt), *activation_statistics(gen)),
            "Diversity": float(np.linalg.norm(gen[i1] - gen[i2], axis=1).mean()),
            "gt_Diversity": float(np.linalg.norm(gt[i1] - gt[i2], axis=1).mean()),
        }
