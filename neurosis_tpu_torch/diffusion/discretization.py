"""Sigma tables (port of neurosis_tpu/diffusion/discretization.py, LegacyDDPM).

Tables are built on the host in numpy (float64 where the reference uses
it) and handed out as float32 tensors on the caller's device (CUDA unless asked).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


def generate_roughly_equally_spaced_steps(num_substeps: int, max_step: int) -> np.ndarray:
    return np.linspace(max_step - 1, 0, num_substeps, endpoint=False).astype(int)[::-1]


def make_beta_schedule(n_timestep: int, linear_start: float = 1e-4, linear_end: float = 2e-2) -> np.ndarray:
    """The 'linear' DDPM beta schedule (reference modules/diffusion/util.py:22-52)."""
    return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2


class LegacyDDPMDiscretization:
    """DDPM beta schedule → alpha-bar → sigma table, descending, with a
    trailing zero (the constructor's ``do_append_zero``, as the reference
    honours only that flag)."""

    do_append_zero = True

    def __init__(self, linear_start: float = 0.00085, linear_end: float = 0.0120, num_timesteps: int = 1000):
        self.num_timesteps = num_timesteps
        alphas = 1.0 - make_beta_schedule(num_timesteps, linear_start, linear_end)
        self.alphas_cumprod = np.cumprod(alphas, axis=0).astype(np.float32)

    def get_sigmas(self, n: int) -> np.ndarray:
        if n < self.num_timesteps:
            alphas_cumprod = self.alphas_cumprod[generate_roughly_equally_spaced_steps(n, self.num_timesteps)]
        elif n == self.num_timesteps:
            alphas_cumprod = self.alphas_cumprod
        else:
            raise ValueError(f"n ({n}) must be <= num_timesteps ({self.num_timesteps})")
        sigmas = ((1 - alphas_cumprod) / alphas_cumprod) ** 0.5
        return sigmas[::-1].astype(np.float32)

    def table(self, n: int, flip: bool = False) -> np.ndarray:
        sigmas = self.get_sigmas(n)
        if self.do_append_zero:
            sigmas = np.concatenate([sigmas, np.zeros((1,), dtype=sigmas.dtype)])
        if flip:
            sigmas = sigmas[::-1]
        return np.ascontiguousarray(sigmas).astype(np.float32)

    def __call__(self, n: int, flip: bool = False, device: DeviceLike = None) -> torch.Tensor:
        return torch.as_tensor(self.table(n, flip=flip), device=resolve_device(device))
