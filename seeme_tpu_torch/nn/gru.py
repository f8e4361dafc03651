"""Bidirectional GRU encoders of the TM2T evaluator (`seeme_tpu/nn/gru.py`,
the reference's `t2m_textenc.py:6-48` and `t2m_motionenc.py:6-62`).

`BiGru` is `nn.GRU` (one layer, both directions, torch's gate order r, z, n
and its state-dict keys `weight_ih_l0`, ..., `_reverse`) run over packed
sequences: each row's forward state stops at its own last valid frame and
its backward pass starts there, which is what the JAX package's masked scan
gives on ragged lengths, with no sorting of rows. The encoders keep the
reference's module names (`pos_emb`, `input_emb`, `gru`, `output_net`,
`hidden`; `main`, `out_net`), so the released `text_mot_match` weights
load as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence


class BiGru(nn.GRU):
    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True, bidirectional=True)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor],
                h0: torch.Tensor) -> torch.Tensor:
        """x (B, T, D), lengths (B,) (None: all T), h0 (2, B, H) -> the
        final states of both directions, (B, 2H)."""
        B, T, _ = x.shape
        if lengths is None:
            lengths = torch.full((B,), T)
        packed = pack_padded_sequence(x, lengths.detach().to("cpu", torch.int64),
                                      batch_first=True, enforce_sorted=False)
        _, h = super().forward(packed, h0.contiguous())
        return torch.cat([h[0], h[1]], dim=-1)


def _head(hidden_size: int, output_size: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(2 * hidden_size, hidden_size), nn.LayerNorm(hidden_size),
                         nn.LeakyReLU(0.2), nn.Linear(hidden_size, output_size))


class TextEncoderBiGRUCo(nn.Module):
    """Word vectors plus embedded POS one-hots -> BiGRU -> MLP head."""

    def __init__(self, word_size: int = 300, pos_size: int = 15, hidden_size: int = 512,
                 output_size: int = 512):
        super().__init__()
        self.pos_emb = nn.Linear(pos_size, word_size)
        self.input_emb = nn.Linear(word_size, hidden_size)
        self.gru = BiGru(hidden_size, hidden_size)
        self.output_net = _head(hidden_size, output_size)
        self.hidden = nn.Parameter(torch.empty(2, 1, hidden_size))

    def forward(self, word_embs, pos_onehot, cap_lens):
        inputs = self.input_emb(word_embs + self.pos_emb(pos_onehot))
        h0 = self.hidden.expand(-1, inputs.shape[0], -1)
        return self.output_net(self.gru(inputs, cap_lens, h0))


class MovementConvEncoder(nn.Module):
    """Two stride-2 1-D convolutions (kernel 4) with leaky ReLUs, then a linear."""

    def __init__(self, input_size: int, hidden_size: int = 512, output_size: int = 512):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv1d(input_size, hidden_size, 4, 2, 1), nn.Dropout(0.2), nn.LeakyReLU(0.2),
            nn.Conv1d(hidden_size, output_size, 4, 2, 1), nn.Dropout(0.2), nn.LeakyReLU(0.2))
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:  # (B, T, D) -> (B, T // 4, out)
        return self.out_net(self.main(inputs.permute(0, 2, 1)).permute(0, 2, 1))


class MotionEncoderBiGRUCo(nn.Module):
    def __init__(self, input_size: int = 512, hidden_size: int = 1024, output_size: int = 512):
        super().__init__()
        self.input_emb = nn.Linear(input_size, hidden_size)
        self.gru = BiGru(hidden_size, hidden_size)
        self.output_net = _head(hidden_size, output_size)
        self.hidden = nn.Parameter(torch.empty(2, 1, hidden_size))

    def forward(self, inputs, m_lens):
        x = self.input_emb(inputs)
        return self.output_net(self.gru(x, m_lens, self.hidden.expand(-1, x.shape[0], -1)))
