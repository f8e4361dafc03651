"""Synthetic HumanML3D-shaped text-to-motion data (`seeme_tpu/data/humanml.py`).

A numpy copy of the JAX package's `SyntheticT2MDataset`: the same seed gives
the same arrays (per-class base pose plus a drifting random walk of length
40..196, 263-d RIC features, pseudo text embeddings tied to the class), and
the data module's `renorm` and `feats2joints` (RIC recovery, 22 joints for
263 features). The real-release loader is not ported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.ric import recover_from_ric

HUMANML_NFEATS = 263
KIT_NFEATS = 251


class SyntheticT2MDataset:
    def __init__(self, num_samples: int = 64, max_len: int = 196, min_len: int = 40,
                 nfeats: int = HUMANML_NFEATS, seed: int = 0, text_dim: int = 768):
        rng = np.random.RandomState(seed)
        self.max_len = max_len
        self.nfeats = nfeats
        self.lengths = rng.randint(min_len, max_len + 1, num_samples)
        # class tables from a fixed stream, shared by every split
        crng = np.random.RandomState(7777)
        base = crng.randn(7, nfeats).astype(np.float32) * 0.4
        drift = crng.randn(7, nfeats).astype(np.float32) * 0.01
        self.motions = []
        for i in range(num_samples):
            c = i % 7
            self.motions.append(base[c] + np.cumsum(
                rng.randn(self.lengths[i], nfeats).astype(np.float32) * 0.05 + drift[c], axis=0))
        flat = np.concatenate(self.motions)
        self.mean = flat.mean(0)
        self.std = flat.std(0) + 1e-6
        self.text_embs = crng.randn(7, text_dim).astype(np.float32)[np.arange(num_samples) % 7]

    def __len__(self) -> int:
        return len(self.motions)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        m = (self.motions[idx] - self.mean) / self.std
        out = np.zeros((self.max_len, self.nfeats), np.float32)
        out[: len(m)] = m
        return {"motion": out, "length": np.int32(len(m)), "text_emb": self.text_embs[idx]}

    def batch(self, start: int, batch_size: int) -> Dict[str, np.ndarray]:
        """Samples [start, start + batch_size) in order, stacked."""
        items = [self[i] for i in range(start, start + batch_size)]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


def renorm(features: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    return features * std + mean


def feats2joints(features: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Normalized (B, T, nfeats) features -> (B, T, njoints, 3) joints."""
    njoints = 22 if features.shape[-1] == HUMANML_NFEATS else 21
    return recover_from_ric(renorm(features, mean, std), njoints)
