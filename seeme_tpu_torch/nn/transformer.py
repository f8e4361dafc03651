"""Post-norm transformer layers and the U-skip stacks (`seeme_tpu/nn/transformer.py`).

Batch-first (B, T, D). Key masks are validity masks (True = attend). The
attention keeps torch's packed `in_proj_weight` layout so the state dict
matches the reference's `nn.MultiheadAttention`. GELU is the exact erf form
(`seeme_tpu/nn/transformer.py:27-31`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9  # additive mask value, finite so a fully masked row stays NaN-free

_ACT = {"relu": F.relu, "gelu": F.gelu}


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, query, key, value, key_valid_mask: Optional[torch.Tensor] = None):
        B, Tq, D = query.shape
        H = self.num_heads
        hd = D // H
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(query, wq, bq).reshape(B, Tq, H, hd)
        k = F.linear(key, wk, bk).reshape(B, -1, H, hd)
        v = F.linear(value, wv, bv).reshape(B, -1, H, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if key_valid_mask is not None:
            logits = logits + torch.where(key_valid_mask, 0.0, NEG_INF)[:, None, None, :]
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, Tq, D)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Post-norm self-attention + FFN block."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int, activation: str = "gelu"):
        super().__init__()
        self.activation = activation
        self.self_attn = MultiHeadAttention(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, src, key_valid_mask=None):
        src = self.norm1(src + self.self_attn(src, src, src, key_valid_mask))
        h = self.linear2(_ACT[self.activation](self.linear1(src)))
        return self.norm2(src + h)


class TransformerDecoderLayer(nn.Module):
    """Post-norm self-attention + cross-attention + FFN block."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int, activation: str = "gelu"):
        super().__init__()
        self.activation = activation
        self.self_attn = MultiHeadAttention(d_model, num_heads)
        self.multihead_attn = MultiHeadAttention(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.norm3 = nn.LayerNorm(d_model)

    def forward(self, tgt, memory, tgt_valid_mask=None, memory_valid_mask=None):
        tgt = self.norm1(tgt + self.self_attn(tgt, tgt, tgt, tgt_valid_mask))
        tgt = self.norm2(tgt + self.multihead_attn(tgt, memory, memory, memory_valid_mask))
        h = self.linear2(_ACT[self.activation](self.linear1(tgt)))
        return self.norm3(tgt + h)


class _SkipStack(nn.Module):
    """(L-1)/2 input blocks, a middle block, (L-1)/2 output blocks, each
    output block preceded by Linear(2d -> d) over [x; popped skip]."""

    def __init__(self, make_layer: Callable[[], nn.Module], num_layers: int, d_model: int):
        super().__init__()
        assert num_layers % 2 == 1, "U-skip stacks need an odd layer count"
        n_block = (num_layers - 1) // 2
        self.input_blocks = nn.ModuleList([make_layer() for _ in range(n_block)])
        self.middle_block = make_layer()
        self.output_blocks = nn.ModuleList([make_layer() for _ in range(n_block)])
        self.linear_blocks = nn.ModuleList(
            [nn.Linear(2 * d_model, d_model) for _ in range(n_block)])
        self.norm = nn.LayerNorm(d_model)

    def _run(self, x, call):
        skips = []
        for block in self.input_blocks:
            x = call(block, x)
            skips.append(x)
        x = call(self.middle_block, x)
        for block, linear in zip(self.output_blocks, self.linear_blocks):
            x = linear(torch.cat([x, skips.pop()], dim=-1))
            x = call(block, x)
        return self.norm(x)


class SkipTransformerEncoder(_SkipStack):
    def forward(self, x, **layer_kwargs):
        return self._run(x, lambda block, h: block(h, **layer_kwargs))


class SkipTransformerDecoder(_SkipStack):
    def forward(self, tgt, memory, tgt_valid_mask=None, memory_valid_mask=None):
        return self._run(
            tgt, lambda block, h: block(h, memory, tgt_valid_mask, memory_valid_mask))
