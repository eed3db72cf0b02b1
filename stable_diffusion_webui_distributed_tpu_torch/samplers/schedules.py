"""Noise schedules: trained DDPM betas -> k-diffusion sigma ladders.

Port of the JAX package's ``samplers/schedules.py``. The schedule constants
stay numpy; the log-sigma interpolations run in f32 torch, as the JAX package
runs them in f32 jnp.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Trained-model noise schedule constants (host-side, numpy)."""

    alphas_cumprod: np.ndarray  # (T,)
    prediction_type: str = "epsilon"

    @property
    def sigmas(self) -> np.ndarray:
        """k-diffusion sigma per trained timestep: sqrt((1-acp)/acp)."""
        acp = self.alphas_cumprod
        return np.sqrt((1.0 - acp) / acp)

    @property
    def log_sigmas(self) -> np.ndarray:
        return np.log(self.sigmas)

    @property
    def sigma_min(self) -> float:
        return float(self.sigmas[0])

    @property
    def sigma_max(self) -> float:
        return float(self.sigmas[-1])

    def sigma_to_t(self, sigma: torch.Tensor) -> torch.Tensor:
        """Fractional trained-timestep for a sigma (k-diffusion convention:
        linear interpolation in log-sigma space), f32."""
        log_sigmas = torch.from_numpy(self.log_sigmas).to(sigma.device)
        log_sigma = torch.log(torch.clamp(sigma, min=1e-10))
        idx = torch.searchsorted(log_sigmas, log_sigma)
        low = torch.clamp(idx - 1, 0, log_sigmas.shape[0] - 2)
        high = low + 1
        w = (log_sigma - log_sigmas[low]) / (log_sigmas[high]
                                             - log_sigmas[low])
        return low + torch.clamp(w, 0.0, 1.0)

    def t_to_sigma(self, t) -> torch.Tensor:
        """Sigma for a fractional trained-timestep (log-space interp)."""
        log_sigmas = torch.from_numpy(self.log_sigmas)
        t = torch.as_tensor(np.asarray(t, np.float32))
        low = torch.clamp(torch.floor(t).to(torch.int32), 0,
                          log_sigmas.shape[0] - 1)
        high = torch.clamp(low + 1, 0, log_sigmas.shape[0] - 1)
        w = t - low
        return torch.exp((1 - w) * log_sigmas[low.long()]
                         + w * log_sigmas[high.long()])


def sd_schedule(num_train_timesteps: int = 1000,
                beta_start: float = 0.00085,
                beta_end: float = 0.012,
                prediction_type: str = "epsilon") -> NoiseSchedule:
    """The scaled-linear schedule every SD 1.x/2.x/XL checkpoint trained on."""
    betas = np.linspace(beta_start**0.5, beta_end**0.5,
                        num_train_timesteps, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    return NoiseSchedule(acp.astype(np.float32), prediction_type)


def default_sigmas(schedule: NoiseSchedule, steps: int) -> np.ndarray:
    """k-diffusion ``get_sigmas``: uniform in trained-timestep space, log-sigma
    interpolated, with a terminal zero. Returns (steps+1,)."""
    t = np.linspace(len(schedule.alphas_cumprod) - 1, 0, steps)
    sigmas = schedule.t_to_sigma(t).numpy()
    return np.append(sigmas, 0.0).astype(np.float32)


def karras_sigmas(schedule: NoiseSchedule, steps: int,
                  rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) rho-schedule between the trained sigma extremes."""
    ramp = np.linspace(0, 1, steps)
    min_inv = schedule.sigma_min ** (1 / rho)
    max_inv = schedule.sigma_max ** (1 / rho)
    sigmas = (max_inv + ramp * (min_inv - max_inv)) ** rho
    return np.append(sigmas, 0.0).astype(np.float32)


def ddim_sigmas(schedule: NoiseSchedule, steps: int) -> np.ndarray:
    """DDIM's uniform ("leading") timestep subset expressed as sigmas, so the
    deterministic DDIM update coincides with an Euler step over this ladder."""
    T = len(schedule.alphas_cumprod)
    stride = T // steps
    ts = np.arange(0, steps) * stride  # leading spacing, as webui's DDIM
    sig = schedule.sigmas[ts][::-1].copy()
    return np.append(sig, 0.0).astype(np.float32)


def exponential_sigmas(schedule: NoiseSchedule, steps: int) -> np.ndarray:
    """Log-uniform ladder ("exponential" in k-diffusion)."""
    sigmas = np.exp(np.linspace(np.log(schedule.sigma_max),
                                np.log(schedule.sigma_min), steps))
    return np.append(sigmas, 0.0).astype(np.float32)


SCHEDULES = {
    "default": default_sigmas,
    "karras": karras_sigmas,
    "ddim": ddim_sigmas,
    "exponential": exponential_sigmas,
}
