"""The HumanAct12 action-recognition evaluator
(`seeme_tpu/eval/action_classifier.py`, the reference's action2motion GRU,
`mld/models/architectures/humanact12_gru.py:6-82`).

A stacked `nn.GRU` (2 layers, hidden 128) over packed sequences: each
row's state stops at its own last valid frame, which is what the JAX
package's masked scan gives on ragged lengths, with no sorting of rows
(lengths go to the host). The initial state is zero, the JAX package's
deliberate deviation from the reference's unseeded `torch.randn`. The top
layer's final state gives the 30-d FID feature `tanh(linear1(h))` and the
logits `linear2(feature)`. The keys are the reference's
(`recurrent.weight_ih_l{k}`, `weight_hh_l{k}`, `bias_*`, `linear1`,
`linear2`), so the released `humanact12_gru.tar` loads as it is; the
inverse of `tools/convert_checkpoint.py::convert_a2m_gru`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence

__all__ = ["MotionDiscriminator"]

FEATURE_SIZE = 30


class MotionDiscriminator(nn.Module):
    def __init__(self, input_size: int = 72, hidden_size: int = 128, num_layers: int = 2,
                 output_size: int = 12):
        super().__init__()
        self.recurrent = nn.GRU(input_size, hidden_size, num_layers, batch_first=True)
        self.linear1 = nn.Linear(hidden_size, FEATURE_SIZE)
        self.linear2 = nn.Linear(FEATURE_SIZE, output_size)

    def forward(self, motion: torch.Tensor, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """motion (B, T, input_size) joint positions, lengths (B,) (None: all
        T) -> (logits (B, output_size), features (B, 30))."""
        B, T, _ = motion.shape
        if lengths is None:
            lengths = torch.full((B,), T)
        packed = pack_padded_sequence(motion, lengths.detach().to("cpu", torch.int64),
                                      batch_first=True, enforce_sorted=False)
        _, h = self.recurrent(packed)
        feats = torch.tanh(self.linear1(h[-1]))
        return self.linear2(feats), feats
