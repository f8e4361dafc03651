"""GloVe word vectorizer of the TM2T evaluator
(`seeme_tpu/data/word_vectorizer.py`, the reference's
`mld/data/humanml/utils/word_vectorizer.py:46`).

`WordVectorizer(meta_root)` reads the GloVe matrix and vocabulary
(`{prefix}_data.npy`, `{prefix}_words.pkl`, `{prefix}_idx.pkl`) when they are
under `meta_root`; otherwise (`is_fallback`) every word gets the JAX
package's md5-seeded hashed vector. A `word/POS` token maps to (word vector
(300,), POS one-hot (15,)): an in-vocabulary VIP word's POS is remapped to
its VIP class (first class wins, in the reference's order), an
out-of-vocabulary word takes the `unk` vector and the OTHER tag.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import List, Tuple

import numpy as np

POS_ENUMERATOR = {
    "VERB": 0, "NOUN": 1, "DET": 2, "ADP": 3, "NUM": 4, "AUX": 5,
    "PRON": 6, "ADJ": 7, "ADV": 8, "Loc_VIP": 9, "Body_VIP": 10,
    "Obj_VIP": 11, "Act_VIP": 12, "Desc_VIP": 13, "OTHER": 14,
}
WORD_DIM = 300
POS_DIM = len(POS_ENUMERATOR)

# `word_vectorizer.py:22-44`
VIP_DICT = {
    "Loc_VIP": ("left", "right", "clockwise", "counterclockwise", "anticlockwise", "forward",
                "back", "backward", "up", "down", "straight", "curve"),
    "Body_VIP": ("arm", "chin", "foot", "feet", "face", "hand", "mouth", "leg", "waist", "eye",
                 "knee", "shoulder", "thigh"),
    "Obj_VIP": ("stair", "dumbbell", "chair", "window", "floor", "car", "ball", "handrail",
                "baseball", "basketball"),
    "Act_VIP": ("walk", "run", "swing", "pick", "bring", "kick", "put", "squat", "throw", "hop",
                "dance", "jump", "turn", "stumble", "dance", "stop", "sit", "lift", "lower",
                "raise", "wash", "stand", "kneel", "stroll", "rub", "bend", "balance", "flap",
                "jog", "shuffle", "lean", "rotate", "spin", "spread", "climb"),
    "Desc_VIP": ("slowly", "carefully", "fast", "careful", "slow", "quickly", "happy", "angry",
                 "sad", "happily", "angrily", "sadly"),
}
WORD_TO_VIP = {}
for _cls, _words in VIP_DICT.items():
    for _w in _words:
        WORD_TO_VIP.setdefault(_w, _cls)


class WordVectorizer:
    def __init__(self, meta_root: str | None = None, prefix: str = "our_vab"):
        self.is_fallback = True
        if meta_root and os.path.exists(os.path.join(meta_root, f"{prefix}_data.npy")):
            self.word2vec = np.load(os.path.join(meta_root, f"{prefix}_data.npy"))
            with open(os.path.join(meta_root, f"{prefix}_idx.pkl"), "rb") as f:
                self.word2idx = pickle.load(f)
            self.is_fallback = False

    @staticmethod
    def _hash_vec(word: str) -> np.ndarray:
        h = int(hashlib.md5(word.encode()).hexdigest(), 16)
        return (np.random.RandomState(h % (2**32)).randn(WORD_DIM).astype(np.float32)
                / np.sqrt(WORD_DIM))

    def __getitem__(self, item: str) -> Tuple[np.ndarray, np.ndarray]:
        """'word/POS' -> (word vector (300,), POS one-hot (15,))."""
        word, pos = item.split("/") if "/" in item else (item, "OTHER")
        in_vocab = self.is_fallback or word in self.word2idx
        pos = WORD_TO_VIP.get(word, pos) if in_vocab else "OTHER"
        pos_vec = np.zeros(POS_DIM, np.float32)
        pos_vec[POS_ENUMERATOR.get(pos, POS_ENUMERATOR["OTHER"])] = 1.0
        if self.is_fallback:
            return self._hash_vec(word), pos_vec
        idx = self.word2idx[word] if word in self.word2idx else self.word2idx.get("unk", 0)
        return self.word2vec[idx].astype(np.float32), pos_vec

    def tokens_to_arrays(self, tokens: List[str], max_text_len: int = 20):
        """Caption tokens -> (word vectors (max_text_len + 2, 300), POS
        one-hots (max_text_len + 2, 15), length) with the reference's sos /
        eos tokens around at most `max_text_len` words (`dataset.py:300-320`)."""
        tokens = ["sos/OTHER"] + tokens[:max_text_len] + ["eos/OTHER"]
        words = np.zeros((max_text_len + 2, WORD_DIM), np.float32)
        pos = np.zeros((max_text_len + 2, POS_DIM), np.float32)
        for i, t in enumerate(tokens):
            words[i], pos[i] = self[t]
        return words, pos, np.int32(len(tokens))
