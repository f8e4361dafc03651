"""PyTorch/CUDA port of `seeme_tpu` for NVIDIA Hopper (H100).

The layout follows `seeme_tpu/` module for module. This package imports
torch, numpy and the standard library only; the JAX package is the reference
it is tested against (`tests/test_torch_*.py`), never a dependency.

Two sampling paths are ported: the EgoBody flagship (interactee VAE encode
and PointNet scene encode -> DDIM-50 over the MD-transformer denoiser -> VAE
decode -> SMPL FK -> ego metrics), and HumanML3D text-to-motion (pooled text
embedding -> DDIM-50 over the token-concat denoiser -> VAE decode -> RIC
joints -> MR metrics). Their hand-written CUDA kernels live in `csrc/` and
are bound through `ops/`.
"""
