"""DDIM reverse process (`seeme_tpu/diffusion/sampling.py:24-70`), eta=0.

A Python loop over the steps. Classifier-free guidance runs the doubled
batch [uncond; cond] through one denoiser call and mixes
`uncond + s * (cond - uncond)`. `z_init` injects externally drawn noise so
two implementations can replay the same draw.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .schedulers import DiffusionSchedule

# denoiser_fn(sample (B, N, D), t (B,)) -> model_output (B, N, D)
DenoiserFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def ddim_sample(
    denoiser_fn: DenoiserFn,
    schedule: DiffusionSchedule,
    shape: tuple,
    num_inference_steps: int = 50,
    guidance_scale: float = 1.0,
    z_init: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device="cpu",
) -> torch.Tensor:
    if z_init is None:
        z_init = torch.randn(shape, generator=generator, device=device)
    latents = z_init.to(torch.float32) * schedule.init_noise_sigma
    do_cfg = guidance_scale > 1.0
    for t in schedule.ddim_timesteps(num_inference_steps):
        model_in = torch.cat([latents, latents]) if do_cfg else latents
        t_batch = torch.full((model_in.shape[0],), int(t), dtype=torch.int64,
                             device=latents.device)
        pred = denoiser_fn(model_in, t_batch)
        if do_cfg:
            uncond, cond = pred.chunk(2)
            pred = uncond + guidance_scale * (cond - uncond)
        latents = schedule.ddim_step(pred, int(t), latents, num_inference_steps)
    return latents
