"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. When CUDA
is missing and the caller did not pass ``device="cpu"``, they raise: the port
never falls back to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "seeme_tpu_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev
