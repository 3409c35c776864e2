"""Noise schedule: DDPM training utilities, deterministic DDIM sampling
(eta = 0, epsilon prediction) and DPM-Solver++(2M) over the same timesteps.

The alpha table and the solver's coefficient tables are float64 on the host
and enter the update as fp32, like the JAX package; eps and x are fp32 in the
update.
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

    def sample_timesteps_biased(self, generator: torch.Generator, batch: int, min_step: int,
                                min_step_prob: float) -> torch.Tensor:
        """Stage 3's high-noise sampler (train_cam_obj_ctrl.py:793-800): with
        probability ``min_step_prob`` t in [min_step, T), else [0, min_step).
        Three draws in this order: the high t, the low t, the uniforms."""
        dev = generator.device
        high = torch.randint(min_step, self.num_train_timesteps, (batch,), generator=generator,
                             device=dev)
        low = torch.randint(0, min_step, (batch,), generator=generator, device=dev)
        take_high = torch.rand((batch,), generator=generator, device=dev) < min_step_prob
        return torch.where(take_high, high, low)

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def ddim_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """'leading' spacing: (arange(n) * (T // n)).round()[::-1] + steps_offset."""
        step_ratio = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        return ts + self.steps_offset

    def dpmpp_2m_tables(self, num_inference_steps: int) -> dict:
        """Per-step coefficients of deterministic DPM-Solver++(2M) (data
        prediction) on the DDIM timestep table, float64:

            m_i    = c_to_x0_x[i] x_i + c_to_x0_eps[i] eps_i
            x_i+1  = c_sample[i] x_i + c_d0[i] m_i + c_d1[i] (m_i - m_i-1)

        with alpha = sqrt(abar), sigma = sqrt(1 - abar), lambda =
        log(alpha / sigma), h_i = lambda_i+1 - lambda_i, c_sample =
        sigma_i+1 / sigma_i, c_d0 = -alpha_i+1 (e^-h_i - 1), c_d1 = c_d0 h_i /
        (2 h_i-1).  c_d1 is 0 at the first and the last step; the last node
        has sigma 0 (alpha 1), so the last update returns m_i."""
        ts = self.ddim_timesteps(num_inference_steps)
        abar = self.alphas_cumprod
        prev_ts = ts - self.num_train_timesteps // num_inference_steps
        alpha = np.sqrt(abar[ts])
        sigma = np.sqrt(1.0 - abar[ts])
        lam = np.log(alpha) - np.log(sigma)
        abar_next = np.where(prev_ts >= 0, abar[np.maximum(prev_ts, 0)], 1.0)
        alpha_next = np.sqrt(abar_next)
        sigma_next = np.sqrt(1.0 - abar_next)
        with np.errstate(divide="ignore"):
            lam_next = np.log(alpha_next) - np.log(sigma_next)  # +inf where sigma is 0
        h = lam_next - lam
        with np.errstate(over="ignore"):
            phi = np.expm1(-h)  # -1 exactly on the final step
        c_d0 = -alpha_next * phi
        n = len(ts)
        c_d1 = np.zeros(n)
        if n > 2:
            h_prev = lam[1:] - lam[:-1]
            c_d1[1:n - 1] = 0.5 * c_d0[1:n - 1] * h[1:n - 1] / h_prev[:n - 2]
        return {"c_to_x0_x": 1.0 / alpha, "c_to_x0_eps": -sigma / alpha,
                "c_sample": sigma_next / sigma, "c_d0": c_d0, "c_d1": c_d1}

    def dpmpp_2m_step(self, model_eps: torch.Tensor, idx: int, sample: torch.Tensor,
                      m_prev: torch.Tensor, tables: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """One DPM-Solver++(2M) update at step ``idx``: (x_next in the
        sample's type, m_i in fp32), m_i carried as the next ``m_prev``."""
        c = {k: torch.tensor(v[idx], dtype=torch.float32, device=sample.device)
             for k, v in tables.items()}
        eps32 = model_eps.float()
        x32 = sample.float()
        m0 = c["c_to_x0_x"] * x32 + c["c_to_x0_eps"] * eps32
        if self.clip_sample:
            m0 = m0.clamp(-1.0, 1.0)
        x_next = c["c_sample"] * x32 + c["c_d0"] * m0 + c["c_d1"] * (m0 - m_prev)
        return x_next.to(sample.dtype), m0

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
