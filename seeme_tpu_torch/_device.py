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


def full_float32() -> None:
    """Run float32 matrix products and cuDNN convolutions in full float32:
    cuDNN's default is TF32 for convolutions (about three decimal digits),
    which the image encoder's card-vs-CPU agreement cannot take. The JAX
    package's tests pin `highest` for the same reason."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
