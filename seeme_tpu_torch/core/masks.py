"""Length / padding mask helpers (`seeme_tpu/core/masks.py`)."""

from __future__ import annotations

import torch


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool mask, True for valid frames."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos < lengths[:, None]
