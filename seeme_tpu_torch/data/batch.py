"""Batch order and padding (`seeme_tpu/data/batch.py:56-103`), numpy only.

A batch is a dict of fixed-shape per-sample arrays (the EgoBody contract:
`feats` (B, T, 2, P), `transl` (B, 2, T, 3), `betas` (B, 2, T, 10), `cam`
(B, T, 6), `length` (B,), and `scene` (B, N, 3) or cached `scene_feats`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _first_len(v):
    if isinstance(v, (np.ndarray, list)):
        return len(v)
    if isinstance(v, dict):
        for x in v.values():
            n = _first_len(x)
            if n is not None:
                return n
    return None


def _pad_rows(v, pad: int):
    if isinstance(v, np.ndarray):
        return np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
    if isinstance(v, list):
        return v + [v[-1]] * pad
    if isinstance(v, dict):
        return {k: _pad_rows(x, pad) for k, x in v.items()}
    return v


def pad_batch(batch: Dict, batch_size: int):
    """Pad every per-sample field (arrays, lists, nested dicts of them) to
    `batch_size` rows by repeating the last example; returns
    (padded_batch, n_valid)."""
    n = _first_len(batch)
    if n is None or n >= batch_size:
        return batch, n if n is not None else batch_size
    return _pad_rows(batch, batch_size - n), n


def eval_batches(datamodule, split: str, batch_size: int, seed: int = 0):
    """Yield (batch, n_valid) covering every sample of `split` once, the
    trailing partial batch padded to `batch_size` (the reference's eval
    loaders do not drop it)."""
    for batch in datamodule.batches(split, batch_size, shuffle=False, seed=seed,
                                    drop_last=False):
        yield pad_batch(batch, batch_size)


def epoch_indices(n: int, batch_size: int, shuffle: bool = True, seed: int = 0,
                  drop_last: bool = True):
    """The one batch-order generator every loader slices with: an int index
    array of `batch_size` per step, shuffled by `np.random.RandomState(seed)`
    as the JAX package does, so both train on the same batch sequence."""
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    stop = (n // batch_size) * batch_size if drop_last else n
    for i in range(0, stop, batch_size):
        yield idx[i: i + batch_size]
