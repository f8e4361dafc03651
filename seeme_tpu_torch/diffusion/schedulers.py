"""DDIM schedule numerics, diffusers-compatible (`seeme_tpu/diffusion/schedulers.py`).

'scaled_linear' betas over 1000 steps, set_alpha_to_one=false,
steps_offset=1, epsilon prediction, clip_sample=false: the shipped
`configs/modules/scheduler.yaml`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class DiffusionSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    init_noise_sigma: float = 1.0
    alphas_cumprod: np.ndarray = field(init=False, repr=False)  # f32, host side

    def __post_init__(self):
        # 'scaled_linear' betas, in f64 as the JAX package computes them
        betas = np.linspace(self.beta_start**0.5, self.beta_end**0.5,
                            self.num_train_timesteps, dtype=np.float64) ** 2
        object.__setattr__(self, "alphas_cumprod",
                           np.cumprod(1.0 - betas).astype(np.float32))

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
                  num_inference_steps: int) -> torch.Tensor:
        """One eta=0 x_t -> x_{t-k} DDIM update (diffusers DDIMScheduler.step)
        for an epsilon prediction."""
        acp_t = sample.new_tensor(float(self.alphas_cumprod[t]))
        acp_prev = sample.new_tensor(self.alpha_prev(int(t), num_inference_steps))
        x0 = (sample - torch.sqrt(1.0 - acp_t) * model_output) / torch.sqrt(acp_t)
        return torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev) * model_output
