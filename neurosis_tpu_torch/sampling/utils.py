"""Sampler math utilities (port of neurosis_tpu/sampling/utils.py; parity:
modules/diffusion/sampling/utils.py:18-95).

The noise source takes an explicit ``torch.Generator`` and draws on the
caller's device (CUDA unless asked). The σ-schedule helpers of the JAX
module (get_sigmas_*) are not ported: nothing calls them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..utils import append_dims


def to_d(x: torch.Tensor, sigma: torch.Tensor, denoised: torch.Tensor) -> torch.Tensor:
    """Denoiser output → Karras ODE derivative."""
    return (x - denoised) / append_dims(sigma, x.ndim)


def to_neg_log_sigma(sigma: torch.Tensor) -> torch.Tensor:
    return -torch.log(sigma)


def to_sigma(neg_log_sigma: torch.Tensor) -> torch.Tensor:
    return torch.exp(-neg_log_sigma)


def default_noise_sampler(generator: Optional[torch.Generator], shape, dtype=None,
                          device: DeviceLike = None) -> torch.Tensor:
    """Gaussian noise for the ancestral samplers (sampling/utils.py:11), drawn
    from ``generator`` (the JAX function takes a key in its place)."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype or torch.float32,
                       device=resolve_device(device))


def get_ancestral_step(sigma_from: torch.Tensor, sigma_to: torch.Tensor, eta: float = 1.0):
    """(sigma_down, sigma_up) for ancestral steps (utils.py:33-43)."""
    if not eta:
        return sigma_to, torch.zeros_like(sigma_to)
    sigma_up = torch.minimum(
        sigma_to,
        eta * torch.sqrt(sigma_to**2 * (sigma_from**2 - sigma_to**2) / torch.clamp_min(sigma_from**2, 1e-20)),
    )
    sigma_down = torch.sqrt(torch.clamp_min(sigma_to**2 - sigma_up**2, 0.0))
    return sigma_down, sigma_up


def linear_multistep_coeff(order: int, t: np.ndarray, i: int, j: int, epsrel: float = 1e-4) -> float:
    """LMS integration coefficient by quadrature over the host σ table
    (utils.py:18-30)."""
    from scipy import integrate

    if order - 1 > i:
        raise ValueError(f"Order {order} too high for step {i}")

    def fn(tau):
        prod = 1.0
        for k in range(order):
            if j == k:
                continue
            prod *= (tau - t[i - k]) / (t[i - j] - t[i - k])
        return prod

    return integrate.quad(fn, t[i], t[i + 1], epsrel=epsrel)[0]
