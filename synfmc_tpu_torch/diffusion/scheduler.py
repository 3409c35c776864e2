"""Noise schedule: DDPM training utilities and deterministic DDIM sampling
(eta = 0, epsilon prediction).

The alpha table is float64 on the host and enters the update as fp32, like
the JAX package; eps and x are fp32 in the update.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class DiffusionSchedule:
    num_train_timesteps: int
    alphas_cumprod: np.ndarray  # (T,) float64
    steps_offset: int = 1
    clip_sample: bool = False

    @classmethod
    def from_config(cls, num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                    beta_end: float = 0.012, beta_schedule: str = "linear",
                    steps_offset: int = 1, clip_sample: bool = False,
                    **_unused) -> "DiffusionSchedule":
        if beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
        elif beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                                dtype=np.float64) ** 2
        else:
            raise ValueError(f"unsupported beta_schedule {beta_schedule!r}")
        return cls(num_train_timesteps=num_train_timesteps,
                   alphas_cumprod=np.cumprod(1.0 - betas), steps_offset=steps_offset,
                   clip_sample=clip_sample)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """sqrt(abar_t) x0 + sqrt(1 - abar_t) noise (DDPMScheduler.add_noise);
        t: (B,) int timesteps; the coefficients are cast to x0's type."""
        abar = torch.as_tensor(self.alphas_cumprod.astype(np.float32), device=x0.device)[
            t.to(x0.device).long()]
        shape = (-1,) + (1,) * (x0.dim() - 1)
        sqrt_abar = torch.sqrt(abar).reshape(shape).to(x0.dtype)
        sqrt_1m = torch.sqrt(1.0 - abar).reshape(shape).to(x0.dtype)
        return sqrt_abar * x0 + sqrt_1m * noise

    def sample_timesteps(self, generator: torch.Generator, batch: int) -> torch.Tensor:
        """(B,) uniform integer timesteps in [0, num_train_timesteps)."""
        return torch.randint(0, self.num_train_timesteps, (batch,), generator=generator,
                             device=generator.device)

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def ddim_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """'leading' spacing: (arange(n) * (T // n)).round()[::-1] + steps_offset."""
        step_ratio = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        return ts + self.steps_offset

    def ddim_step(self, model_eps: torch.Tensor, t: int, sample: torch.Tensor,
                  num_inference_steps: int) -> torch.Tensor:
        abar = self.alphas_cumprod.astype(np.float32)
        prev_t = int(t) - self.num_train_timesteps // num_inference_steps
        alpha_t = torch.tensor(abar[int(t)], dtype=torch.float32, device=sample.device)
        # the final step lands on alpha 1 (diffusers' set_alpha_to_one default)
        alpha_prev = torch.tensor(abar[prev_t] if prev_t >= 0 else 1.0, dtype=torch.float32,
                                  device=sample.device)
        eps32 = model_eps.float()
        x32 = sample.float()
        pred_x0 = (x32 - torch.sqrt(1.0 - alpha_t) * eps32) / torch.sqrt(alpha_t)
        if self.clip_sample:
            pred_x0 = pred_x0.clamp(-1.0, 1.0)
        prev = torch.sqrt(alpha_prev) * pred_x0 + torch.sqrt(1.0 - alpha_prev) * eps32
        return prev.to(sample.dtype)
