"""PyTorch/CUDA port of `seeme_tpu` for NVIDIA Hopper (H100).

The layout follows `seeme_tpu/` module for module. This package imports
torch, numpy and the standard library only; the JAX package is the reference
it is tested against (`tests/test_torch_*.py`), never a dependency.

Slice one covers the EgoBody flagship sampling path: interactee VAE encode
and PointNet scene encode -> DDIM-50 over the MD-transformer denoiser -> VAE
decode -> SMPL FK -> ego metrics. Its three hand-written CUDA kernels live in
`csrc/` and are bound through `ops/`.
"""
