"""Sigma tables (port of neurosis_tpu/diffusion/discretization.py).

Tables are built on the host in numpy (float64 where the reference uses
it: the DDPM betas, the tan and rectified-flow ramps) and handed out as
float32 tensors on the caller's device (CUDA unless asked). ``table(n)`` is
the descending table, largest σ first, with a trailing zero when the
constructor's ``do_append_zero`` is set: the reference's ``__call__`` takes
the flag too but honours only the constructor's, and so does the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


def generate_roughly_equally_spaced_steps(num_substeps: int, max_step: int) -> np.ndarray:
    return np.linspace(max_step - 1, 0, num_substeps, endpoint=False).astype(int)[::-1]


def make_beta_schedule(n_timestep: int, linear_start: float = 1e-4, linear_end: float = 2e-2) -> np.ndarray:
    """The 'linear' DDPM beta schedule (reference modules/diffusion/util.py:22-52)."""
    return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2


class Discretization:
    """Base: ``get_sigmas(n)`` is the descending table without the zero."""

    def __init__(self, do_append_zero: bool = True):
        self.do_append_zero = do_append_zero

    def get_sigmas(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def table(self, n: int, flip: bool = False) -> np.ndarray:
        sigmas = self.get_sigmas(n)
        if self.do_append_zero:
            sigmas = np.concatenate([sigmas, np.zeros((1,), dtype=sigmas.dtype)])
        if flip:
            sigmas = sigmas[::-1]
        return np.ascontiguousarray(sigmas).astype(np.float32)

    def __call__(self, n: int, do_append_zero: bool | None = None, flip: bool = False,
                 device: DeviceLike = None) -> torch.Tensor:
        return torch.as_tensor(self.table(n, flip=flip), device=resolve_device(device))


class EDMcDiscretization(Discretization):
    """Log-linear σ ramp over [sigma_min, sigma_max], descending."""

    def __init__(self, do_append_zero: bool = True, sigma_min: float = 0.001, sigma_max: float = 1000.0):
        super().__init__(do_append_zero)
        self.sigma_min, self.sigma_max = sigma_min, sigma_max

    def get_sigmas(self, n: int) -> np.ndarray:
        return np.exp(np.linspace(math.log(self.sigma_min), math.log(self.sigma_max), n, dtype=np.float32))[::-1]


class EDMcSimpleDiscretization(Discretization):
    """A num_sigmas log-linear table subsampled by strided back-indexing, plus
    a zero of its own (so two zeros with ``do_append_zero``, as in JAX)."""

    def __init__(self, do_append_zero: bool = True, sigma_min: float = 0.001, sigma_max: float = 1000.0,
                 num_sigmas: int = 1000):
        super().__init__(do_append_zero)
        self.sigma_min, self.sigma_max, self.num_sigmas = sigma_min, sigma_max, num_sigmas

    def get_sigmas(self, n: int) -> np.ndarray:
        table = np.exp(np.linspace(math.log(self.sigma_min), math.log(self.sigma_max), self.num_sigmas,
                                   dtype=np.float32))
        ss = len(table) / n
        return np.asarray([float(table[-(1 + int(x * ss))]) for x in range(n)] + [0.0], dtype=np.float32)


class RectifiedFlowDiscretization(Discretization):
    """σ = t/(1−t) over t evenly in [start_shift, 1 − end_shift], in float64."""

    def __init__(self, start_shift: float = 0.0, end_shift: float = 0.001, do_append_zero: bool = False):
        super().__init__(do_append_zero)
        self.start_shift, self.end_shift = start_shift, end_shift

    def get_sigmas(self, n: int) -> np.ndarray:
        t = np.linspace(self.start_shift, 1 - self.end_shift, n, dtype=np.float64)
        return (t / (1.0 - t))[::-1].astype(np.float32)


class RectifiedFlowComfyDiscretization(Discretization):
    """σ = t over [start_shift, 1 − end_shift] (the comfy convention)."""

    def __init__(self, start_shift: float = 0.0, end_shift: float = 0.001, do_append_zero: bool = False):
        super().__init__(do_append_zero)
        self.start_shift, self.end_shift = start_shift, end_shift

    def get_sigmas(self, n: int) -> np.ndarray:
        return np.linspace(self.start_shift, 1 - self.end_shift, n, dtype=np.float64)[::-1].astype(np.float32)


class TanZeroSNRDiscretization(Discretization):
    """σ = scale·tan(θ), θ evenly in [start_shift, π/2 − end_shift], float64:
    a zero-terminal-SNR schedule whose largest σ is tan(π/2 − 0.001) ≈ 1000."""

    def __init__(self, start_shift: float = 0.001, end_shift: float = 0.001, scale: float = 1.0):
        super().__init__(do_append_zero=True)
        self.start_shift, self.end_shift, self.scale = start_shift, end_shift, scale

    def get_sigmas(self, n: int) -> np.ndarray:
        half_pi = np.arccos(np.zeros(1, dtype=np.float64))[0]
        theta = np.linspace(self.start_shift, half_pi - self.end_shift, n, dtype=np.float64)
        return (np.tan(theta) * self.scale)[::-1].astype(np.float32)


class EDMDiscretization(Discretization):
    """The Karras ρ-ramp from sigma_max down to sigma_min."""

    def __init__(self, sigma_min: float = 0.002, sigma_max: float = 80.0, rho: float = 7.0):
        super().__init__(do_append_zero=True)
        self.sigma_min, self.sigma_max, self.rho = sigma_min, sigma_max, rho

    def get_sigmas(self, n: int) -> np.ndarray:
        ramp = np.linspace(0, 1, n, dtype=np.float32)
        min_inv_rho = self.sigma_min ** (1 / self.rho)
        max_inv_rho = self.sigma_max ** (1 / self.rho)
        return ((max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** self.rho).astype(np.float32)


class LegacyDDPMDiscretization(Discretization):
    """DDPM beta schedule → alpha-bar → σ table, descending."""

    def __init__(self, linear_start: float = 0.00085, linear_end: float = 0.0120, num_timesteps: int = 1000):
        super().__init__(do_append_zero=True)
        self.linear_start, self.linear_end, self.num_timesteps = linear_start, linear_end, num_timesteps
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
