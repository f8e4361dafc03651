"""The text / motion co-embedding evaluator behind the TM2T metrics
(`seeme_tpu/eval/t2m_evaluator.py`, the reference's `t2m_eval`,
`mld.py:1955-1995`).

Captions go through `WordVectorizer` (word vectors and POS one-hots, sos /
eos around at most 20 words) and `TextEncoderBiGRUCo`; motions, in the
evaluator's normalization, go through `MovementConvEncoder` over
`feats[..., :-4]` (the foot contacts dropped) and `MotionEncoderBiGRUCo`
over `lengths // unit_len` steps. Rows stay in batch order: the packed
BiGRU needs no sort by length.

Without weights the three modules run their seeded random init
(`is_pretrained` False): the protocol runs, the numbers compare with
nothing. `ckpt` loads the released `text_mot_match` weights: a torch file
(or the release's directory, holding `model/finest.tar`) with the three
state dicts under `text_encoder`, `movement_encoder` and `motion_encoder`,
under the reference's key names.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..data.word_vectorizer import WordVectorizer
from ..nn.gru import MotionEncoderBiGRUCo, MovementConvEncoder, TextEncoderBiGRUCo
from ..nn.init import init_parameters_

PARTS = ("text_encoder", "movement_encoder", "motion_encoder")


def evaluator_state_dicts(path: str) -> dict:
    """{part: state dict} from a released evaluator file or its directory."""
    if os.path.isdir(path):
        path = os.path.join(path, "model", "finest.tar")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return {part: ckpt[part] for part in PARTS}


class T2MEvaluator(nn.Module):
    def __init__(self, nfeats: int = 263, unit_len: int = 4, max_text_len: int = 20,
                 ckpt: Optional[str] = None, glove_root: Optional[str] = None,
                 word_size: int = 300, pos_size: int = 15, text_hidden: int = 512,
                 move_hidden: int = 512, move_out: int = 512, motion_hidden: int = 1024,
                 output_size: int = 512, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.unit_len, self.max_text_len = unit_len, max_text_len
        self.vectorizer = WordVectorizer(glove_root)
        self.text_encoder = TextEncoderBiGRUCo(word_size, pos_size, text_hidden, output_size)
        self.movement_encoder = MovementConvEncoder(nfeats - 4, move_hidden, move_out)
        self.motion_encoder = MotionEncoderBiGRUCo(move_out, motion_hidden, output_size)
        init_parameters_(self, torch.Generator().manual_seed(seed))
        self.is_pretrained = False
        if ckpt:
            for part, sd in evaluator_state_dicts(ckpt).items():
                getattr(self, part).load_state_dict(sd, strict=True)
            self.is_pretrained = True
        self.requires_grad_(False)
        self.eval()
        self.to(dev)
        self.device = dev

    @torch.no_grad()
    def embed_motion(self, feats, lengths) -> np.ndarray:
        """(B, T, nfeats) features in the evaluator's normalization, (B,)
        lengths -> (B, output_size)."""
        feats = torch.as_tensor(np.asarray(feats) if not torch.is_tensor(feats) else feats,
                                dtype=torch.float32, device=self.device)
        lengths = torch.as_tensor(lengths, device=self.device)
        mov = self.movement_encoder(feats[..., :-4])
        return self.motion_encoder(mov, lengths // self.unit_len).cpu().numpy()

    @torch.no_grad()
    def embed_text(self, texts: List[str]) -> np.ndarray:
        """Captions (whitespace tokens, 'word/POS' honoured) -> (B, output_size)."""
        rows = [self.vectorizer.tokens_to_arrays(t.split(), self.max_text_len) for t in texts]
        words, pos, lens = (np.stack([r[i] for r in rows]) for i in range(3))
        emb = self.text_encoder(torch.as_tensor(words, device=self.device),
                                torch.as_tensor(pos, device=self.device), torch.as_tensor(lens))
        return emb.cpu().numpy()
