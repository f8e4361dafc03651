"""HumanML3D / KIT text-to-motion data (`seeme_tpu/data/humanml.py`), numpy
batches.

`SyntheticT2MDataset` is a numpy copy of the JAX package's: the same seed
gives the same arrays (per-class base pose plus a drifting random walk of
length 40..196, RIC features, a caption and a pseudo text embedding tied to
the class). `HumanML3DDataModule` is the JAX data module: the standard
release under `root` (`new_joint_vecs/<id>.npy` features, `texts/<id>.txt`
`caption#tokens` lines, `{train,val,test}.txt` ids, `Mean.npy` / `Std.npy`,
and the evaluator's `Mean_eval.npy` / `Std_eval.npy` when present) or,
without it, synthetic splits of 256 / 64 / 64 (32 / 33 / 33 under DEBUG).
The release is read per batch in the order of `random.Random(seed)` (a
shuffled id list, then each
clip cropped to whole units of 4 frames at a random start when
shuffling), so both packages give the same batches. 263 features and 22 joints for HumanML3D, 251 and 21 for
KIT. `feats2joints` recovers the joints from normalized features by RIC.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..core.ric import recover_from_ric
from ..utils.profiling import span
from .batch import epoch_indices

HUMANML_NFEATS = 263
KIT_NFEATS = 251
MIN_LEN = 40     # DATASET.SAMPLER.MIN_LEN
UNIT_LEN = 4     # the reference's crop unit


class SyntheticT2MDataset:
    def __init__(self, num_samples: int = 64, max_len: int = 196, min_len: int = MIN_LEN,
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
        self.texts = [f"a person performs action {i % 7}" for i in range(num_samples)]
        self.text_embs = crng.randn(7, text_dim).astype(np.float32)[np.arange(num_samples) % 7]

    def __len__(self) -> int:
        return len(self.motions)

    def __getitem__(self, idx: int) -> Dict:
        m = (self.motions[idx] - self.mean) / self.std
        out = np.zeros((self.max_len, self.nfeats), np.float32)
        out[: len(m)] = m
        return {"motion": out, "length": np.int32(len(m)), "text": self.texts[idx],
                "text_emb": self.text_embs[idx]}

    def stack(self, indices) -> Dict:
        """The samples at `indices`, arrays stacked, captions as a list."""
        items = [self[int(i)] for i in indices]
        return {k: [it[k] for it in items] if k == "text" else np.stack([it[k] for it in items])
                for k in items[0]}

    def batch(self, start: int, batch_size: int) -> Dict:
        """Samples [start, start + batch_size) in order."""
        return self.stack(range(start, start + batch_size))


def renorm(features: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    return features * std + mean


def feats2joints(features: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normalized (B, T, nfeats) features -> (B, T, njoints, 3) joints, the
    recovery computed in `dtype` and returned in the features' dtype.
    float64 keeps the recovery's own rounding out of the integration of
    the root's rotation and velocity over the frames."""
    njoints = 22 if features.shape[-1] == HUMANML_NFEATS else 21
    raw = renorm(features.to(dtype), mean.to(dtype), std.to(dtype))
    with span("joints.fk"):
        return recover_from_ric(raw, njoints).to(features.dtype)


class HumanML3DDataModule:
    def __init__(self, root: Optional[str] = None, nfeats: int = HUMANML_NFEATS,
                 max_len: int = 196, min_len: int = MIN_LEN, text_dim: int = 768,
                 num_train: int = 256):
        self.nfeats = nfeats
        self.njoints = 22 if nfeats == HUMANML_NFEATS else 21
        self.max_len, self.min_len, self.unit_len = max_len, min_len, UNIT_LEN
        self.name = "humanml3d" if nfeats == HUMANML_NFEATS else "kit"
        self.is_synthetic = root is None or not os.path.isdir(os.path.join(root, "new_joint_vecs"))
        self.mean_eval = self.std_eval = None
        if self.is_synthetic:
            n_eval = max(num_train // 4, 33)  # a pool of 32 and one more, as the JAX module
            self._sets = {split: SyntheticT2MDataset(size, max_len, min_len, nfeats, seed, text_dim)
                          for split, size, seed in (("train", num_train, 0), ("val", n_eval, 1),
                                                    ("test", n_eval, 2))}
            self.mean, self.std = self._sets["train"].mean, self._sets["train"].std
            self.num_train = num_train
            return
        self.root = root
        self.mean = np.load(os.path.join(root, "Mean.npy"))
        self.std = np.load(os.path.join(root, "Std.npy"))
        for stat, name in (("mean_eval", "Mean_eval.npy"), ("std_eval", "Std_eval.npy")):
            path = os.path.join(root, name)
            if os.path.exists(path):
                setattr(self, stat, np.load(path))
        self._ids: Dict[str, List[str]] = {}
        for split in ("train", "val", "test"):
            with open(os.path.join(root, f"{split}.txt")) as f:
                self._ids[split] = [ln.strip() for ln in f if ln.strip()]
        self.num_train = len(self._ids["train"])

    def _load_real(self, idx: str):
        m = np.load(os.path.join(self.root, "new_joint_vecs", idx + ".npy"))
        with open(os.path.join(self.root, "texts", idx + ".txt")) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        return m.astype(np.float32), lines[0].split("#")[0] if lines else ""

    def split_arrays(self, split: str) -> Dict[str, np.ndarray]:
        """Per-sample arrays of a synthetic split; the release has none
        (its captions are encoded per batch): KeyError."""
        if not self.is_synthetic:
            raise KeyError("per-sample arrays: synthetic humanml only")
        data = self._sets[split].stack(range(len(self._sets[split])))
        return {k: data[k] for k in ("motion", "length", "text_emb")}

    def batch_indices(self, split: str, batch_size: int, shuffle=None, seed: int = 0,
                      drop_last: bool = True):
        if not self.is_synthetic:
            raise KeyError("per-sample arrays: synthetic humanml only")
        if shuffle is None:
            shuffle = split == "train"
        return epoch_indices(len(self._sets[split]), batch_size, shuffle=shuffle, seed=seed,
                             drop_last=drop_last)

    def batches(self, split: str, batch_size: int, shuffle=None, seed: int = 0,
                drop_last: bool = True) -> Iterator[Dict]:
        """Batches of `motion` (B, max_len, nfeats), `length`, `text` (a list)
        and, synthetic only, `text_emb`."""
        if shuffle is None:
            shuffle = split == "train"
        if self.is_synthetic:
            for sel in self.batch_indices(split, batch_size, shuffle, seed, drop_last):
                yield self._sets[split].stack(sel)
            return
        rng = random.Random(seed)
        ids = list(self._ids[split])
        if shuffle:
            rng.shuffle(ids)
        batch: List[Dict] = []
        for idx in ids:
            try:
                m, caption = self._load_real(idx)
            except FileNotFoundError:
                continue
            if len(m) < self.min_len:
                continue
            L = (len(m) // self.unit_len) * self.unit_len
            start = rng.randint(0, len(m) - L) if shuffle and len(m) > L else 0
            m = m[start: start + L][: self.max_len]
            feat = np.zeros((self.max_len, self.nfeats), np.float32)
            feat[: len(m)] = (m - self.mean) / self.std
            batch.append({"motion": feat, "length": np.int32(len(m)), "text": caption})
            if len(batch) == batch_size:
                yield _stack(batch)
                batch = []
        if batch and not drop_last:
            yield _stack(batch)

    def renorm(self, features: np.ndarray) -> np.ndarray:
        return features * self.std + self.mean

    def renorm4t2m(self, features: np.ndarray) -> np.ndarray:
        """Dataset normalization -> the evaluator's (`mld/data/HumanML3D.py:47-55`);
        the raw features when the release has no evaluator statistics (and
        on the synthetic data)."""
        raw = features * self.std + self.mean
        if self.mean_eval is not None:
            return (raw - self.mean_eval) / self.std_eval
        return raw

    def feats2joints(self, features: torch.Tensor) -> torch.Tensor:
        """Normalized features -> (B, T, njoints, 3) joints by RIC recovery."""
        stats = [torch.as_tensor(s, device=features.device) for s in (self.mean, self.std)]
        return feats2joints(features, *stats)


def _stack(items: List[Dict]) -> Dict:
    return {"motion": np.stack([b["motion"] for b in items]),
            "length": np.stack([b["length"] for b in items]),
            "text": [b["text"] for b in items]}
