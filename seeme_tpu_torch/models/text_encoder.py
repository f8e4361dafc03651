"""Frozen text encoder of the text-to-motion model
(`seeme_tpu/models/text_encoder.py`), numpy out.

The mode follows the reference's choice by model path and the
`last_hidden_state` flag (`mld_clip.py:38-48`): "clip" (one pooled (B, 1, D)
token), "clip_hidden" (the text tower's (B, max_length, D) hidden states) or
"bert" (a BERT-family encoder's hidden states, zero past each caption's
tokens). A `modelpath` that names an existing directory is loaded with
transformers' PyTorch classes (`CLIPTextModelWithProjection`, or
`AutoModel` for a bert path, and `AutoTokenizer`) onto `device`, and
captions are tokenized as the JAX encoder tokenizes them (padding to
`max_length`, truncation; a bert tokenizer's `model_max_length` caps it).
Where the JAX encoder falls back to hashed words on any load error
(`seeme_tpu/models/text_encoder.py:81-86`), this one raises: an
ImportError naming transformers when it is not installed, transformers'
own error naming the file it misses otherwise, so a swapped text encoder
never passes silently. Without a directory (no path, or a path that is not
on disk) every mode runs the JAX package's deterministic hashed-word
fallback (`is_fallback`): the same caption gives the same embedding, and
captions that share words give correlated ones.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np
import torch


def hashed_word_vector(word: str, dim: int) -> np.ndarray:
    """N(0, 1) vector of `dim` seeded by the word's md5."""
    h = int(hashlib.md5(word.encode()).hexdigest(), 16)
    return np.random.RandomState(h % (2**32)).randn(dim).astype(np.float32)


class ClipTextEncoder:
    def __init__(self, modelpath: Optional[str] = None, latent_dim: int = 768,
                 last_hidden_state: bool = False, max_length: int = 77,
                 device: str | torch.device = "cpu"):
        self.latent_dim = latent_dim
        self.max_length = max_length
        self.is_fallback = True
        self.device = torch.device(device)
        self._model = self._tokenizer = None
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
            self._load(modelpath, max_length)

    def _load(self, modelpath: str, max_length: int) -> None:
        config = os.path.join(modelpath, "config.json")
        if not os.path.exists(config):
            raise FileNotFoundError(f"{config} not found: {modelpath} is not a transformers "
                                    "model directory")
        try:
            import transformers
        except ImportError as e:
            raise ImportError(f"{modelpath}: loading a CLIP or BERT text encoder needs the "
                              f"transformers package, which is not installed ({e})") from e
        self._tokenizer = transformers.AutoTokenizer.from_pretrained(modelpath)
        if self.name == "bert":
            self._model = transformers.AutoModel.from_pretrained(modelpath)
            self.max_length = min(max_length, self._tokenizer.model_max_length)
        else:
            self._model = transformers.CLIPTextModelWithProjection.from_pretrained(modelpath)
        self._model.to(self.device).eval()
        self.is_fallback = False

    def _tokens(self, texts: List[str]):
        return self._tokenizer(texts, padding="max_length", truncation=True,
                               max_length=self.max_length, return_tensors="pt")

    @torch.no_grad()
    def __call__(self, texts: List[str]) -> np.ndarray:
        """Captions -> (B, 1, D) pooled ("clip") or (B, max_length, D) token
        embeddings ("clip_hidden", "bert"). A loaded model runs on the
        encoder's device (the CLIP tower on the token ids alone, as the JAX
        encoder calls it). The fallback's pooled mode sums the words'
        vectors over sqrt(word count), its token modes place each word's
        vector at its position and leave the rest zero."""
        if self._model is not None:
            tokens = {k: v.to(self.device) for k, v in self._tokens(texts).items()}
            if self.name == "bert":
                out = self._model(**tokens).last_hidden_state
                out = out * tokens["attention_mask"][..., None]
            else:
                out = self._model(input_ids=tokens["input_ids"])
                out = out.last_hidden_state if self.name == "clip_hidden" else \
                    out.text_embeds[:, None, :]
            return out.float().cpu().numpy()
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
        """(B, max_length) bool, True for a caption's tokens (the
        tokenizer's attention mask; the fallback's words, at least one
        position), for the token modes; None for the pooled mode."""
        if self.name == "clip":
            return None
        if self._tokenizer is not None:
            return self._tokens(texts)["attention_mask"].numpy().astype(bool)
        mask = np.zeros((len(texts), self.max_length), bool)
        for i, t in enumerate(texts):
            mask[i, : max(min(len(t.split()), self.max_length), 1)] = True
        return mask
