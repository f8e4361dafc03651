"""Reverse processes (`seeme_tpu/diffusion/sampling.py:24-135`).

Python loops over the steps. Classifier-free guidance runs the doubled
batch [uncond; cond] through one denoiser call and mixes
`uncond + s * (cond - uncond)`. `z_init` injects externally drawn initial
noise and `noise` (steps, *shape) each step's, so two implementations can
replay the same draws; otherwise both come from `generator`.

  * `ddim_sample`: DDIM over the leading-spaced inference timesteps, at
    any eta (eta > 0 adds each step's noise);
  * `ddpm_sample`: the ancestral DDPM process over every training timestep;
  * `ddim_sample_with_trajectory`: eta-0 DDIM that also returns every
    step's latents (the `_diffusion_reverse_tsne` path).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..utils.profiling import span
from .schedulers import DiffusionSchedule

# denoiser_fn(sample (B, N, D), t (B,)) -> model_output (B, N, D)
DenoiserFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _start(shape, z_init, generator, device) -> torch.Tensor:
    if z_init is None:
        z_init = torch.randn(shape, generator=generator, device=device)
    return z_init.to(torch.float32)


def _guided(denoiser_fn: DenoiserFn, latents: torch.Tensor, t: int,
            guidance_scale: float) -> torch.Tensor:
    """The denoiser's output at t, mixed from the [uncond; cond] halves of
    the doubled batch when guidance > 1."""
    do_cfg = guidance_scale > 1.0
    model_in = torch.cat([latents, latents]) if do_cfg else latents
    t_batch = torch.full((model_in.shape[0],), int(t), dtype=torch.int64, device=latents.device)
    pred = denoiser_fn(model_in, t_batch)
    if do_cfg:
        uncond, cond = pred.chunk(2)
        pred = uncond + guidance_scale * (cond - uncond)
    return pred


def _step_noise(noise: Optional[Sequence[torch.Tensor]], i: int, like: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    if noise is not None:
        return noise[i].to(like.device, torch.float32)
    return torch.randn(like.shape, generator=generator, device=like.device)


def ddim_sample(
    denoiser_fn: DenoiserFn,
    schedule: DiffusionSchedule,
    shape: tuple,
    num_inference_steps: int = 50,
    guidance_scale: float = 1.0,
    z_init: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device="cpu",
    eta: float = 0.0,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """x_0 samples of `shape` by DDIM; at eta > 0 step i adds `noise[i]`,
    or a draw from `generator`; the whole loop is one `sample.denoise` span."""
    with span("sample.denoise"):
        latents = _start(shape, z_init, generator, device) * schedule.init_noise_sigma
        for i, t in enumerate(schedule.ddim_timesteps(num_inference_steps)):
            pred = _guided(denoiser_fn, latents, t, guidance_scale)
            eps = _step_noise(noise, i, latents, generator) if eta > 0 else None
            latents = schedule.ddim_step(pred, int(t), latents, num_inference_steps, eta, eps)
        return latents


def ddpm_sample(
    denoiser_fn: DenoiserFn,
    schedule: DiffusionSchedule,
    shape: tuple,
    guidance_scale: float = 1.0,
    z_init: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device="cpu",
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """The ancestral DDPM reverse process over all `num_train_timesteps`
    steps, t = T - 1 down to 0; step i draws `noise[i]` (the last step, t =
    0, adds none, as `ddpm_step` does)."""
    latents = _start(shape, z_init, generator, device)
    T = schedule.num_train_timesteps
    for i, t in enumerate(range(T - 1, -1, -1)):
        pred = _guided(denoiser_fn, latents, t, guidance_scale)
        latents = schedule.ddpm_step(pred, t, latents, _step_noise(noise, i, latents, generator))
    return latents


def ddim_sample_with_trajectory(
    denoiser_fn: DenoiserFn,
    schedule: DiffusionSchedule,
    shape: tuple,
    num_inference_steps: int = 50,
    guidance_scale: float = 1.0,
    z_init: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device="cpu",
):
    """(x_0, every step's latents (steps, *shape)) of eta-0 DDIM."""
    latents = _start(shape, z_init, generator, device) * schedule.init_noise_sigma
    traj = []
    for t in schedule.ddim_timesteps(num_inference_steps):
        pred = _guided(denoiser_fn, latents, t, guidance_scale)
        latents = schedule.ddim_step(pred, int(t), latents, num_inference_steps)
        traj.append(latents)
    return latents, torch.stack(traj)
