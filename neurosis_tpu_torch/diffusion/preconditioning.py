"""Denoiser preconditionings (port of neurosis_tpu/diffusion/preconditioning.py):
σ → (c_skip, c_out, c_in, c_noise), elementwise on a σ tensor of any shape;
the denoised estimate is D(x; σ) = network(x·c_in, c_noise)·c_out + x·c_skip."""

from __future__ import annotations

import torch


class DenoiserPreconditioning:
    def __call__(self, sigma: torch.Tensor):
        return self.get_c_skip(sigma), self.get_c_out(sigma), self.get_c_in(sigma), self.get_c_noise(sigma)

    def get_snr(self, sigma: torch.Tensor) -> torch.Tensor:
        return 1.0 / sigma**2  # unit-variance data


class EpsPreconditioning(DenoiserPreconditioning):
    """ε-prediction (SD 1.x): c_skip = 1, c_out = −σ, c_in = 1/√(σ²+1), c_noise = σ."""

    def get_c_skip(self, sigma):
        return torch.ones_like(sigma)

    def get_c_out(self, sigma):
        return -sigma

    def get_c_in(self, sigma):
        return 1.0 / torch.sqrt(sigma**2 + 1.0)

    def get_c_noise(self, sigma):
        return sigma


class VPreconditioning(EpsPreconditioning):
    """v-prediction: c_skip = 1/(σ²+1), c_out = −σ/√(σ²+1)."""

    def get_c_skip(self, sigma):
        return 1.0 / (sigma**2 + 1.0)

    def get_c_out(self, sigma):
        return -sigma / torch.sqrt(sigma**2 + 1.0)


class VPreconditioningWithEDMcNoise(VPreconditioning):
    """v-prediction with EDM's continuous c_noise = log(σ)/4."""

    def get_c_noise(self, sigma):
        return 0.25 * torch.log(sigma)


class EDMPreconditioning(DenoiserPreconditioning):
    """Karras EDM preconditioning with data std ``sigma_data``."""

    def __init__(self, sigma_data: float = 1.0):
        self.sigma_data = sigma_data

    def get_c_skip(self, sigma):
        return self.sigma_data**2 / (sigma**2 + self.sigma_data**2)

    def get_c_out(self, sigma):
        return sigma * self.sigma_data / torch.sqrt(sigma**2 + self.sigma_data**2)

    def get_c_in(self, sigma):
        return 1.0 / torch.sqrt(sigma**2 + self.sigma_data**2)

    def get_c_noise(self, sigma):
        return 0.25 * torch.log(sigma)


class RectifiedFlowXLPreconditioning(DenoiserPreconditioning):
    """Rectified flow with σ = t/(1−t) (SD3-style timestep scaling)."""

    def get_c_skip(self, sigma):
        return torch.ones_like(sigma)

    def get_c_out(self, sigma):
        return -sigma

    def get_c_in(self, sigma):
        s_t = 1.0 / (1.0 + sigma)
        noise_std = torch.sqrt((1.0 / (sigma + 1.0)) ** 2 + (sigma / (sigma + 1.0)) ** 2)
        return s_t / noise_std

    def get_c_noise(self, sigma):
        return 1000.0 * (sigma / (1.0 + sigma))


class RectifiedFlowComfyPreconditioning(DenoiserPreconditioning):
    """Rectified flow with σ = t in [0, 1] (the comfy convention)."""

    def get_c_skip(self, sigma):
        return torch.ones_like(sigma)

    def get_c_out(self, sigma):
        return -sigma

    def get_c_in(self, sigma):
        return 1.0 / torch.sqrt(sigma**2 + (1.0 - sigma) ** 2)

    def get_c_noise(self, sigma):
        return 1000.0 * sigma
