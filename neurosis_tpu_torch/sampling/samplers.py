"""k-diffusion samplers (port of neurosis_tpu/sampling/samplers.py; parity:
modules/diffusion/sampling/sampling.py).

The σ schedule is built on the host from the discretization's table; the
step loop is a Python ``for`` over it, with the carry in fp32 whatever the
latents' dtype. Randomness (the churn noise, the ancestral noise) comes
from an explicit ``torch.Generator``. The churn noise is only drawn where
the churn is on: with ``s_churn = 0``, the configs' setting, it would be
multiplied by zero. The ancestral samplers draw their noise every step,
through an injectable ``noise_sampler(generator, shape, dtype, device)``.
Where JAX selects between two results with ``where`` (the last step's
guards), so does the port.

The denoiser is ``denoise(x, sigma, cond) -> D-output``; the guider wraps
it with CFG's batch doubling.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..utils import append_dims
from .guidance import Guider, IdentityGuider
from .utils import (
    default_noise_sampler,
    get_ancestral_step,
    linear_multistep_coeff,
    to_d,
    to_neg_log_sigma,
    to_sigma,
)

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]


class BaseDiffusionSampler:
    """prepare: σ table, x·√(1+σ₀²), an fp32 carry (sampling.py:50-91)."""

    def __init__(self, discretization, guider: Optional[Guider] = None, num_steps: Optional[int] = None,
                 verbose: bool = False):
        self.discretization = discretization
        self.guider = guider if guider is not None else IdentityGuider()
        self.num_steps = num_steps
        self.verbose = verbose

    def prepare(self, x: torch.Tensor, cond: dict, uc: Optional[dict], num_steps: Optional[int]):
        num_steps = num_steps if num_steps is not None else self.num_steps
        if num_steps is None:
            raise ValueError("Step count must be set at init or call time!")
        self._sigmas_np = self.discretization.table(num_steps)
        sigmas = torch.as_tensor(self._sigmas_np, device=x.device)
        uc = uc if uc is not None else cond
        x = x * float(np.sqrt(1.0 + self._sigmas_np[0] ** 2))
        return x.float(), sigmas, cond, uc

    def denoise(self, x: torch.Tensor, denoiser: DenoiseFn, sigma: torch.Tensor, cond: dict, uc: dict):
        xin, sin, cin = self.guider.prepare_inputs(x, sigma, cond, uc)
        return self.guider(denoiser(xin, sin, cin), sigma)

    @staticmethod
    def s_in(x: torch.Tensor) -> torch.Tensor:
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)


class EDMSampler(BaseDiffusionSampler):
    """Euler/Heun EDM family with churn (sampling.py:140-207)."""

    def __init__(self, s_churn: float = 0.0, s_tmin: float = 0.0, s_tmax: float = float("inf"),
                 s_noise: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.s_churn = s_churn
        self.s_tmin = s_tmin
        self.s_tmax = s_tmax
        self.s_noise = s_noise

    def correction(self, euler_step, x, d, dt, next_sigma, denoiser, cond, uc):
        return euler_step

    @torch.no_grad()
    def __call__(self, denoiser: DenoiseFn, x: torch.Tensor, cond: dict, uc: Optional[dict] = None,
                 num_steps: Optional[int] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, sigmas, cond, uc = self.prepare(x, cond, uc, num_steps)
        n = len(sigmas) - 1
        s_in = self.s_in(x)
        # fp32 gammas from the host table, as the JAX sampler casts them to the carry's dtype
        gammas = [float(np.float32(min(self.s_churn / n, 2**0.5 - 1) if self.s_tmin <= float(s) <= self.s_tmax
                                   else 0.0)) for s in self._sigmas_np[:-1]]
        for i in range(n):
            sigma = s_in * sigmas[i]
            next_sigma = s_in * sigmas[i + 1]
            sigma_hat = sigma * (gammas[i] + 1.0)
            if gammas[i] > 0:
                eps = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype) * self.s_noise
                x = x + eps * append_dims(torch.sqrt(torch.clamp_min(sigma_hat**2 - sigma**2, 0.0)), x.ndim)
            denoised = self.denoise(x, denoiser, sigma_hat, cond, uc)
            d = to_d(x, sigma_hat, denoised)
            dt = append_dims(next_sigma - sigma_hat, x.ndim)
            x = self.correction(x + dt * d, x, d, dt, next_sigma, denoiser, cond, uc)
        return x


class EulerEDMSampler(EDMSampler):
    pass


class HeunEDMSampler(EDMSampler):
    """Heun's correction, except on a step into σ = 0 (sampling.py:155-160)."""

    def correction(self, euler_step, x, d, dt, next_sigma, denoiser, cond, uc):
        denoised = self.denoise(euler_step, denoiser, next_sigma, cond, uc)
        d_new = to_d(euler_step, next_sigma, denoised)
        d_prime = (d + d_new) / 2.0
        return torch.where(append_dims(next_sigma, x.ndim) > 0.0, x + d_prime * dt, euler_step)


class AncestralSampler(BaseDiffusionSampler):
    """Ancestral steps: down to σ_down deterministically, then noise of
    σ_up (sampling.py:163-200). ``noise_sampler(generator, shape, dtype,
    device)`` gives the noise; the default is Gaussian."""

    def __init__(self, eta: float = 1.0, s_noise: float = 1.0, noise_sampler=None, **kwargs):
        super().__init__(**kwargs)
        self.eta = eta
        self.s_noise = s_noise
        self.noise_sampler = noise_sampler or default_noise_sampler

    def ancestral_euler_step(self, x, denoised, sigma, sigma_down):
        d = to_d(x, sigma, denoised)
        dt = append_dims(sigma_down - sigma, x.ndim)
        return x + dt * d

    def ancestral_step(self, x, generator, sigma, next_sigma, sigma_up):
        noise = self.noise_sampler(generator, x.shape, x.dtype, x.device)
        return torch.where(append_dims(next_sigma, x.ndim) > 0.0,
                           x + noise * self.s_noise * append_dims(sigma_up, x.ndim), x)

    def step(self, sigma, next_sigma, denoiser, x, cond, uc, generator):
        raise NotImplementedError

    @torch.no_grad()
    def __call__(self, denoiser: DenoiseFn, x: torch.Tensor, cond: dict, uc: Optional[dict] = None,
                 num_steps: Optional[int] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, sigmas, cond, uc = self.prepare(x, cond, uc, num_steps)
        s_in = self.s_in(x)
        for i in range(len(sigmas) - 1):
            x = self.step(s_in * sigmas[i], s_in * sigmas[i + 1], denoiser, x, cond, uc, generator)
        return x


class EulerAncestralSampler(AncestralSampler):
    """sampling.py:333-341."""

    def step(self, sigma, next_sigma, denoiser, x, cond, uc, generator):
        sigma_down, sigma_up = get_ancestral_step(sigma, next_sigma, eta=self.eta)
        denoised = self.denoise(x, denoiser, sigma, cond, uc)
        x = self.ancestral_euler_step(x, denoised, sigma, sigma_down)
        return self.ancestral_step(x, generator, sigma, next_sigma, sigma_up)


class DPMPP2SAncestralSampler(AncestralSampler):
    """sampling.py:343-379."""

    def step(self, sigma, next_sigma, denoiser, x, cond, uc, generator):
        sigma_down, sigma_up = get_ancestral_step(sigma, next_sigma, eta=self.eta)
        denoised = self.denoise(x, denoiser, sigma, cond, uc)
        x_euler = self.ancestral_euler_step(x, denoised, sigma, sigma_down)

        t, t_next = to_neg_log_sigma(sigma), to_neg_log_sigma(torch.clamp_min(sigma_down, 1e-20))
        h = t_next - t
        s = t + 0.5 * h
        mult1 = append_dims(to_sigma(s) / to_sigma(t), x.ndim)
        mult2 = append_dims(torch.expm1(-0.5 * h), x.ndim)
        mult3 = append_dims(to_sigma(t_next) / to_sigma(t), x.ndim)
        mult4 = append_dims(torch.expm1(-h), x.ndim)

        x2 = mult1 * x - mult2 * denoised
        denoised2 = self.denoise(x2, denoiser, to_sigma(s), cond, uc)
        x_dpmpp2s = mult3 * x - mult4 * denoised2

        x = torch.where(append_dims(sigma_down, x.ndim) > 0.0, x_dpmpp2s, x_euler)
        return self.ancestral_step(x, generator, sigma, next_sigma, sigma_up)


class DPMPP2MSampler(BaseDiffusionSampler):
    """Second-order multistep (sampling.py:381-458): the previous step's
    denoised output rides along."""

    @torch.no_grad()
    def __call__(self, denoiser: DenoiseFn, x: torch.Tensor, cond: dict, uc: Optional[dict] = None,
                 num_steps: Optional[int] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, sigmas, cond, uc = self.prepare(x, cond, uc, num_steps)
        s_in = self.s_in(x)
        old_denoised = torch.zeros_like(x)
        for i in range(len(sigmas) - 1):
            sigma = s_in * sigmas[i]
            next_sigma = s_in * sigmas[i + 1]
            prev_sigma = s_in * sigmas[max(i - 1, 0)]

            denoised = self.denoise(x, denoiser, sigma, cond, uc)

            t, t_next = to_neg_log_sigma(sigma), to_neg_log_sigma(torch.clamp_min(next_sigma, 1e-20))
            h = t_next - t
            mult1 = append_dims(to_sigma(t_next) / to_sigma(t), x.ndim)
            mult2 = append_dims(torch.expm1(-h), x.ndim)
            x_standard = mult1 * x - mult2 * denoised

            # at i = 0, h_last = 0 would make 1/(2r) infinite, and inf·0 = NaN in the discarded branch
            r = (t - to_neg_log_sigma(prev_sigma)) / h if i > 0 else torch.ones_like(h)
            mult3 = append_dims(1 + 1 / (2 * r), x.ndim)
            mult4 = append_dims(1 / (2 * r), x.ndim)
            x_advanced = mult1 * x - mult2 * (mult3 * denoised - mult4 * old_denoised)

            use_advanced = (next_sigma.sum() >= 1e-14) & (i > 0)
            x = torch.where(use_advanced, x_advanced, x_standard)
            old_denoised = denoised
        return x


class LinearMultistepSampler(BaseDiffusionSampler):
    """LMS with quadrature coefficients from the host σ table
    (sampling.py:274-311)."""

    def __init__(self, order: int = 4, **kwargs):
        super().__init__(**kwargs)
        self.order = order

    @torch.no_grad()
    def __call__(self, denoiser: DenoiseFn, x: torch.Tensor, cond: dict, uc: Optional[dict] = None,
                 num_steps: Optional[int] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, sigmas, cond, uc = self.prepare(x, cond, uc, num_steps)
        s_in = self.s_in(x)
        ds = []
        for i in range(len(sigmas) - 1):
            sigma = s_in * sigmas[i]
            denoised = self.denoise(x, denoiser, sigma, cond, uc)
            ds.append(to_d(x, sigma, denoised))
            if len(ds) > self.order:
                ds.pop(0)
            cur_order = min(i + 1, self.order)
            coeffs = [linear_multistep_coeff(cur_order, self._sigmas_np, i, j) for j in range(cur_order)]
            x = x + sum(c * d for c, d in zip(coeffs, reversed(ds)))
        return x
