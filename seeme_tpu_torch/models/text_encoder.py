"""Frozen text encoder of the text-to-motion model
(`seeme_tpu/models/text_encoder.py`), host-side, numpy out.

The mode follows the reference's choice by model path and the
`last_hidden_state` flag (`mld_clip.py:38-48`): "clip" (one pooled (B, 1, D)
token), "clip_hidden" (the text tower's (B, max_length, D) hidden states) or
"bert" (a BERT-family encoder's hidden states). No CLIP or BERT weights are
in the repository, and the port reads none yet: a `modelpath` that names an
existing directory raises `NotImplementedError`; without one (no path, or a
path that is not on disk) every mode runs the JAX package's deterministic
hashed-word fallback (`is_fallback`): the same caption gives the same
embedding, and captions that share words give correlated ones.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np


def hashed_word_vector(word: str, dim: int) -> np.ndarray:
    """N(0, 1) vector of `dim` seeded by the word's md5."""
    h = int(hashlib.md5(word.encode()).hexdigest(), 16)
    return np.random.RandomState(h % (2**32)).randn(dim).astype(np.float32)


class ClipTextEncoder:
    def __init__(self, modelpath: Optional[str] = None, latent_dim: int = 768,
                 last_hidden_state: bool = False, max_length: int = 77):
        self.latent_dim = latent_dim
        self.max_length = max_length
        self.is_fallback = True
        # 'clip' is checked first, then 'bert', on the full path, as the
        # reference does; any other name is refused
        path = (modelpath or "").lower()
        if not path or "clip" in path:
            self.name = "clip_hidden" if last_hidden_state else "clip"
        elif "bert" in path:
            self.name = "bert"
        else:
            raise ValueError(f"text encoder model {modelpath!r} not supported "
                             "(expected a clip or bert asset, `mld_clip.py:38-48`)")
        if modelpath and os.path.isdir(modelpath):
            raise NotImplementedError(
                f"{modelpath}: the port does not load CLIP or BERT weights yet; without "
                "the directory it runs the hashed-word fallback")

    def __call__(self, texts: List[str]) -> np.ndarray:
        """Captions -> (B, 1, D) pooled ("clip") or (B, max_length, D) token
        embeddings ("clip_hidden", "bert"): the pooled mode sums the words'
        vectors over sqrt(word count), the token modes place each word's
        vector at its position and leave the rest zero."""
        if self.name == "clip":
            out = np.zeros((len(texts), 1, self.latent_dim), np.float32)
            for i, t in enumerate(texts):
                for w in t.lower().split():
                    out[i, 0] += hashed_word_vector(w, self.latent_dim)
                out[i] /= np.sqrt(max(len(t.split()), 1))
            return out
        out = np.zeros((len(texts), self.max_length, self.latent_dim), np.float32)
        for i, t in enumerate(texts):
            for p, w in enumerate(t.lower().split()[: self.max_length]):
                out[i, p] = hashed_word_vector(w, self.latent_dim)
        return out

    def token_mask(self, texts: List[str]) -> Optional[np.ndarray]:
        """(B, max_length) bool, True for a caption's words (at least one
        position), for the token modes; None for the pooled mode."""
        if self.name == "clip":
            return None
        mask = np.zeros((len(texts), self.max_length), bool)
        for i, t in enumerate(texts):
            mask[i, : max(min(len(t.split()), self.max_length), 1)] = True
        return mask
