"""Alt sampler system, comfy-style (port of neurosis_tpu/sampling/sampling2.py;
parity: modules/sampling/*).

DiffusionSampler2 (σ table + timestep↔σ maps), SigmaSchedulers
(simple/ddim/uniform/sgm_uniform), NoiseScaling (eps/v/edm). The tables are
host-side numpy (tiny and static per run); the scaling ops take tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils import append_dims


def beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4, linear_end: float = 2e-2,
                  cosine_s: float = 8e-3) -> np.ndarray:
    """DDPM beta schedules (reference: modules/diffusion/util.py:22-52)."""
    if schedule == "linear":
        return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2
    if schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * math.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    raise ValueError(f"schedule '{schedule}' unknown.")


class DiffusionSampler2:
    """σ-table owner with timestep↔σ mapping (common.py:8-41)."""

    sigmas: np.ndarray
    log_sigmas: np.ndarray
    sigma_data: Optional[float]

    def set_sigmas(self, sigmas: np.ndarray, sigma_data: Optional[float] = None):
        self.sigma_data = sigma_data
        self.sigmas = np.asarray(sigmas, np.float32)
        self.log_sigmas = np.log(self.sigmas)

    @property
    def sigma_min(self) -> float:
        return float(self.sigmas[0])

    @property
    def sigma_max(self) -> float:
        return float(self.sigmas[-1])

    def timestep(self, sigma):
        raise NotImplementedError

    def sigma(self, timestep):
        raise NotImplementedError

    def percent_to_sigma(self, percent: float) -> float:
        if percent <= 0.0:
            return 999999999.9
        if percent >= 1.0:
            return 0.0
        return float(self.sigma(np.asarray((1.0 - percent) * 999.0)))


class DiscreteSampler(DiffusionSampler2):
    """β-schedule σ table with log-interp σ(t) (discrete.py:9-52)."""

    def __init__(self, schedule: str = "linear", timesteps: int = 1000, linear_start: float = 0.00085,
                 linear_end: float = 0.012, cosine_s: float = 8e-3):
        self.num_timesteps = int(timesteps)
        betas = beta_schedule(schedule, timesteps, linear_start, linear_end, cosine_s)
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        self.set_sigmas(((1 - alphas_cumprod) / alphas_cumprod) ** 0.5, 1.0)

    def timestep(self, sigma):
        log_sigma = np.log(np.asarray(sigma, np.float32))
        dists = log_sigma - self.log_sigmas[:, None]
        return np.abs(dists).argmin(axis=0).reshape(np.shape(sigma))

    def sigma(self, timestep):
        t = np.clip(np.asarray(timestep, np.float32), 0, len(self.sigmas) - 1)
        w = t - np.floor(t)
        low = (1 - w) * self.log_sigmas[np.floor(t).astype(np.int64)]
        high = w * self.log_sigmas[np.ceil(t).astype(np.int64)]
        return np.exp(low + high).astype(np.float32)


class ContinuousEDMSampler(DiffusionSampler2):
    """log-linear σ table, t = 0.25·log σ (edmc.py:9-38)."""

    def __init__(self, sigma_min: float = 0.001, sigma_max: float = 1000.0, sigma_data: float = 1.0):
        self.set_sigmas(np.exp(np.linspace(math.log(sigma_min), math.log(sigma_max), 1000)), sigma_data)

    def timestep(self, sigma):
        return 0.25 * np.log(np.asarray(sigma, np.float32))

    def sigma(self, timestep):
        return np.exp(np.asarray(timestep, np.float32) / 0.25)

    def percent_to_sigma(self, percent: float) -> float:
        if percent <= 0.0:
            return 999999999.9
        if percent >= 1.0:
            return 0.0
        lo = math.log(self.sigma_min)
        return math.exp((math.log(self.sigma_max) - lo) * (1.0 - percent) + lo)


class TanEDMSampler(ContinuousEDMSampler):
    """tan-spaced σ table (edmc.py:40-56)."""

    def __init__(self, sigma_min: float = 0.001, sigma_max: float = 1000.0, sigma_data: float = 1.0,
                 eps: float = 5e-3):
        half_pi = float(np.arccos(0.0))
        sigmas = np.tan(np.linspace(0.0, half_pi - eps, 1000, dtype=np.float64)).astype(np.float32)
        self.set_sigmas(sigmas, sigma_data)


# -- schedulers (schedule.py:8-77) -----------------------------------------


class SigmaScheduler:
    def __init__(self, sampler: DiffusionSampler2):
        self.sampler = sampler

    def __call__(self, n_steps: int) -> np.ndarray:
        return self.get_schedule(n_steps)

    def get_schedule(self, n_steps: int) -> np.ndarray:
        raise NotImplementedError


class SimpleScheduler(SigmaScheduler):
    def get_schedule(self, n_steps: int) -> np.ndarray:
        stride = len(self.sampler.sigmas) / n_steps
        sched = [float(self.sampler.sigmas[-(int(x * stride) + 1)]) for x in range(n_steps)]
        return np.asarray(sched + [0.0], np.float32)


class DDIMScheduler(SigmaScheduler):
    def get_schedule(self, n_steps: int) -> np.ndarray:
        stride = max(len(self.sampler.sigmas) // n_steps, 1)
        sched = [float(self.sampler.sigmas[x]) for x in range(1, len(self.sampler.sigmas), stride)]
        return np.asarray(sched[::-1] + [0.0], np.float32)


class UniformScheduler(SigmaScheduler):
    def get_schedule(self, n_steps: int) -> np.ndarray:
        start = self.sampler.timestep(self.sampler.sigma_max)
        end = self.sampler.timestep(self.sampler.sigma_min)
        return np.asarray([float(self.sampler.sigma(t)) for t in np.linspace(start, end, n_steps)] + [0.0],
                          np.float32)


class SGMUniformScheduler(SigmaScheduler):
    def get_schedule(self, n_steps: int) -> np.ndarray:
        start = self.sampler.timestep(self.sampler.sigma_max)
        end = self.sampler.timestep(self.sampler.sigma_min)
        ts = np.linspace(start, end, n_steps + 1)[:-1]
        return np.asarray([float(self.sampler.sigma(t)) for t in ts] + [0.0], np.float32)


def get_sigma_scheduler(name: str, sampler: DiffusionSampler2) -> SigmaScheduler:
    table = {"simple": SimpleScheduler, "ddim": DDIMScheduler, "uniform": UniformScheduler,
             "sgm_uniform": SGMUniformScheduler}
    if name not in table:
        raise ValueError(f"Unknown scheduler {name}")
    return table[name](sampler)


# -- noise scaling (scaling.py) ---------------------------------------------


class EpsilonScaling:
    """eps-pred scaling (scaling.py:7-24); σ is [B]."""

    def __init__(self, sigma_data: float = 1.0):
        self.sigma_data = sigma_data

    def calculate_input(self, sigma: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return noise / (append_dims(sigma, noise.ndim) ** 2 + self.sigma_data**2) ** 0.5

    def calculate_denoised(self, sigma, model_output, model_input):
        return model_input - model_output * append_dims(sigma, model_output.ndim)

    def noise_scaling(self, sigma, noise, latents, max_denoise: bool = False):
        if max_denoise:
            noise = noise * torch.sqrt(1.0 + sigma**2.0)
        else:
            noise = noise * sigma
        return noise + latents


class VScaling(EpsilonScaling):
    def calculate_denoised(self, sigma, model_output, model_input):
        s = append_dims(sigma, model_output.ndim)
        c_skip = self.sigma_data**2 / (s**2 + self.sigma_data**2)
        c_out = s * self.sigma_data / (s**2 + self.sigma_data**2) ** 0.5
        return model_input * c_skip - model_output * c_out


class EDMScaling(VScaling):
    def calculate_denoised(self, sigma, model_output, model_input):
        s = append_dims(sigma, model_output.ndim)
        c_skip = self.sigma_data**2 / (s**2 + self.sigma_data**2)
        c_out = s * self.sigma_data / (s**2 + self.sigma_data**2) ** 0.5
        return model_input * c_skip + model_output * c_out
