"""The Euler EDM sampler (port of neurosis_tpu/sampling/samplers.py,
BaseDiffusionSampler, EDMSampler and EulerEDMSampler; parity:
modules/diffusion/sampling/sampling.py:50-207).

The σ schedule is built on the host from the discretization's table; the
step loop is a Python ``for`` over it. The churn noise is drawn from an
explicit ``torch.Generator`` (it is only drawn where the churn is on: with
``s_churn = 0``, the configs' setting, it would be multiplied by zero). The
denoiser is ``denoise(x, sigma, cond) -> D-output``; the guider wraps it with
CFG's batch doubling.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..utils import append_dims
from .guidance import Guider, IdentityGuider
from .utils import to_d

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
        s_in = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
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
