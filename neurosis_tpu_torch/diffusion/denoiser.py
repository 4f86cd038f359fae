"""Preconditioned network calls (port of neurosis_tpu/diffusion/denoiser.py).

A denoiser takes ``network_apply(x, c_noise, cond, **extra) -> out`` so the
same object serves the train step and sampling. ``Denoiser`` is continuous
in σ; ``DiscreteDenoiser`` quantizes σ to its table first. c_in, c_out and
c_skip are cast to the input's dtype before they meet it, as in JAX.
"""

from __future__ import annotations

import torch

from .._device import DeviceLike, resolve_device
from ..utils import append_dims
from .discretization import Discretization
from .preconditioning import DenoiserPreconditioning


class Denoiser:
    def __init__(self, preconditioning: DenoiserPreconditioning):
        self.preconditioning = preconditioning

    def possibly_quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma

    def possibly_quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        return c_noise

    def __call__(self, network_apply, inputs: torch.Tensor, sigma: torch.Tensor, cond: dict,
                 output_mode: str = "D", **additional_model_inputs) -> torch.Tensor:
        sigma = self.possibly_quantize_sigma(sigma)
        c_skip, c_out, c_in, c_noise = self.preconditioning(append_dims(sigma, inputs.ndim))
        c_noise = self.possibly_quantize_c_noise(c_noise.reshape(sigma.shape))
        c_in, c_out, c_skip = (c.to(inputs.dtype) for c in (c_in, c_out, c_skip))
        net = network_apply(inputs * c_in, c_noise, cond, **additional_model_inputs)
        if output_mode == "F":
            return net
        return net * c_out + inputs * c_skip


class DiscreteDenoiser(Denoiser):
    """Quantizes σ to the nearest entry of the discretization's table; with
    ``quantize_c_noise`` the network sees the table index as its timestep.
    ``do_append_zero`` is taken and, as in JAX, not read."""

    def __init__(self, preconditioning: DenoiserPreconditioning, num_idx: int, discretization: Discretization,
                 do_append_zero: bool = False, quantize_c_noise: bool = True, flip: bool = False,
                 device: DeviceLike = None):
        super().__init__(preconditioning)
        self.num_idx = num_idx
        self.quantize_c_noise = quantize_c_noise
        self.sigmas = discretization(num_idx, flip=flip, device=resolve_device(device))
        self.log_sigmas = torch.log(self.sigmas)

    def sigma_to_idx(self, sigma: torch.Tensor) -> torch.Tensor:
        dists = sigma - self.sigmas.reshape((-1,) + (1,) * sigma.ndim)
        return dists.abs().argmin(dim=0).reshape(sigma.shape)

    def idx_to_sigma(self, idx: torch.Tensor) -> torch.Tensor:
        return self.sigmas[idx]

    def possibly_quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return self.idx_to_sigma(self.sigma_to_idx(sigma))

    def possibly_quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        return self.sigma_to_idx(c_noise) if self.quantize_c_noise else c_noise
