"""DDIM / DDPM schedule numerics, diffusers-compatible (`seeme_tpu/diffusion/schedulers.py`).

The defaults are MLD's shipped `configs/modules/scheduler.yaml`:
'scaled_linear' betas over 1000 steps, set_alpha_to_one=false,
steps_offset=1, epsilon prediction, clip_sample=false. `ddim_step` takes
eta > 0 with its per-step noise and either prediction type. EgoHMR's
x0-predicting cosine schedule ('squaredcos_cap_v2', prediction_type
'sample') samples by ancestral DDPM steps over a respaced subsequence
(`space_timesteps`, `respaced_schedule`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import count


def make_betas(num_train_timesteps: int, beta_start: float, beta_end: float,
               beta_schedule: str) -> np.ndarray:
    """f64 betas (`seeme_tpu/diffusion/schedulers.py:27`): MLD's and
    EgoHMR's schedules."""
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                           dtype=np.float64) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        # diffusers' betas_for_alpha_bar with the cosine alpha_bar, beta at most 0.999
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        ts = np.arange(num_train_timesteps, dtype=np.float64)
        return np.minimum(1 - alpha_bar((ts + 1) / num_train_timesteps)
                          / alpha_bar(ts / num_train_timesteps), 0.999)
    raise ValueError(f"unknown beta schedule {beta_schedule}")


@dataclass(frozen=True)
class DiffusionSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"  # or "sample" (x0)
    clip_sample: bool = False         # x0 clipped to [-1, 1]
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    init_noise_sigma: float = 1.0
    betas: np.ndarray = field(init=False, repr=False)           # f32, host side
    alphas_cumprod: np.ndarray = field(init=False, repr=False)  # f32, host side

    def __post_init__(self):
        # in f64 as the JAX package computes them, kept in f32
        self._set(make_betas(self.num_train_timesteps, self.beta_start, self.beta_end,
                             self.beta_schedule))

    def _set(self, betas: np.ndarray) -> None:
        object.__setattr__(self, "betas", betas.astype(np.float32))
        object.__setattr__(self, "alphas_cumprod", np.cumprod(1.0 - betas).astype(np.float32))

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0): sqrt(acp_t) x0 + sqrt(1 - acp_t) noise, one t per
        sample (`seeme_tpu/diffusion/schedulers.py:86-95`)."""
        acp = torch.as_tensor(self.alphas_cumprod, device=x0.device)[timesteps]
        acp = acp.reshape((x0.shape[0],) + (1,) * (x0.ndim - 1))
        return torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise

    def predict_x0(self, model_output: torch.Tensor, t, sample: torch.Tensor) -> torch.Tensor:
        """x0 from the model's output at timestep t (an int, or indices that
        broadcast against sample), clipped to [-1, 1] under `clip_sample`
        (`seeme_tpu/diffusion/schedulers.py:97-110`; false in every config)."""
        if self.prediction_type == "sample":
            x0 = model_output
        elif self.prediction_type == "epsilon":
            count("host_sync.predict_x0_table")   # a copy from the host, on the card a wait
            acp_t = torch.as_tensor(self.alphas_cumprod, device=sample.device)[t]
            x0 = (sample - torch.sqrt(1.0 - acp_t) * model_output) / torch.sqrt(acp_t)
        else:
            raise ValueError(f"unknown prediction type {self.prediction_type}")
        return x0.clamp(-1.0, 1.0) if self.clip_sample else x0

    def ddim_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending inference timesteps, diffusers 'leading' spacing."""
        step_ratio = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        return ts + self.steps_offset

    def alpha_prev(self, t: int, num_inference_steps: int) -> float:
        prev_t = t - self.num_train_timesteps // num_inference_steps
        if prev_t >= 0:
            return float(self.alphas_cumprod[prev_t])
        return 1.0 if self.set_alpha_to_one else float(self.alphas_cumprod[0])

    def ddim_step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor,
                  num_inference_steps: int, eta: float = 0.0,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One x_t -> x_{t-k} DDIM update (diffusers DDIMScheduler.step,
        `seeme_tpu/diffusion/schedulers.py:122-150`): at eta > 0 the step
        adds eta * sigma_t * `noise`, which it then needs."""
        count("host_sync.ddim_step_scalars", 2)   # two copies from the host, on the card waits
        acp_t = sample.new_tensor(float(self.alphas_cumprod[t]))
        acp_prev = sample.new_tensor(self.alpha_prev(int(t), num_inference_steps))
        x0 = self.predict_x0(model_output, int(t), sample)
        if self.prediction_type == "epsilon":
            eps = model_output
        else:
            eps = (sample - torch.sqrt(acp_t) * x0) / torch.sqrt(1.0 - acp_t)
        std = eta * torch.sqrt((1.0 - acp_prev) / (1.0 - acp_t) * (1.0 - acp_t / acp_prev))
        prev = torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev - std ** 2) * eps
        if eta > 0:
            if noise is None:
                raise ValueError("ddim_step: eta > 0 needs noise")
            prev = prev + std * noise
        return prev

    def ddpm_step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
        """One ancestral DDPM update x_t -> x_{t-1} with the 'fixed_small'
        variance (`seeme_tpu/diffusion/schedulers.py:152-172`); no noise at
        t = 0. The coefficients are computed in f32, as the JAX package does."""
        count("host_sync.ddpm_step_scalars", 2)   # two copies from the host, on the card waits
        acp_t = sample.new_tensor(float(self.alphas_cumprod[t]))
        acp_prev = sample.new_tensor(float(self.alphas_cumprod[t - 1]) if t > 0 else 1.0)
        beta_t = 1.0 - acp_t / acp_prev
        x0 = self.predict_x0(model_output, t, sample)
        coeff_x0 = torch.sqrt(acp_prev) * beta_t / (1.0 - acp_t)
        coeff_xt = torch.sqrt(1.0 - beta_t) * (1.0 - acp_prev) / (1.0 - acp_t)
        mean = coeff_x0 * x0 + coeff_xt * sample
        if t == 0:
            return mean
        variance = ((1.0 - acp_prev) / (1.0 - acp_t) * beta_t).clamp_min(1e-20)
        return mean + torch.sqrt(variance) * noise


def space_timesteps(num_timesteps: int, section_counts) -> np.ndarray:
    """guided-diffusion's timestep respacing (`seeme_tpu/diffusion/
    schedulers.py:175`): 'ddimN' takes the stride that gives exactly N
    steps; otherwise comma-separated per-section counts, evenly spaced."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return np.arange(0, num_timesteps, i)
            raise ValueError(f"cannot create exactly {desired} steps with stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    all_steps, start = [], 0
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start + round(cur))
            cur += stride
        start += size
    return np.asarray(sorted(set(all_steps)))


def respaced_schedule(base: DiffusionSchedule,
                      use_timesteps) -> Tuple[DiffusionSchedule, np.ndarray]:
    """A schedule over a subsequence of `base`'s timesteps (`seeme_tpu/
    diffusion/schedulers.py:206`): betas 1 - acp[t_i] / acp[t_{i-1}], so its
    alphas_cumprod is the subsequence. Returns (schedule, timestep_map): the
    sampler walks 0..len-1 of the new schedule and calls the model with
    timestep_map[t]."""
    use = np.asarray(sorted(use_timesteps))
    new_acp = base.alphas_cumprod[use]
    prev = np.concatenate([[1.0], new_acp[:-1]])
    sched = object.__new__(DiffusionSchedule)
    for f in dataclasses.fields(DiffusionSchedule):
        if f.init:
            object.__setattr__(sched, f.name, getattr(base, f.name))
    object.__setattr__(sched, "num_train_timesteps", len(use))
    sched._set(1.0 - new_acp / prev)
    return sched, use


def snr(schedule: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio acp / (1 - acp) at timesteps t
    (`seeme_tpu/diffusion/schedulers.py:232-236`)."""
    t = torch.as_tensor(t)
    acp = torch.as_tensor(schedule.alphas_cumprod, device=t.device)[t]
    return acp / (1.0 - acp)


def ddim_timesteps_static(schedule: DiffusionSchedule, n: int) -> Tuple[torch.Tensor, int]:
    """(the n descending DDIM timesteps as a tensor, their count)
    (`seeme_tpu/diffusion/schedulers.py:239-241`)."""
    ts = schedule.ddim_timesteps(n)
    return torch.as_tensor(ts), len(ts)
