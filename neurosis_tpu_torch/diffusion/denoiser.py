"""Preconditioned network calls (port of neurosis_tpu/diffusion/denoiser.py).

The denoiser takes ``network_apply(x, c_noise, cond) -> out`` so the same
object serves the train step and, later, sampling.
"""

from __future__ import annotations

import torch

from .._device import DeviceLike, resolve_device
from ..utils import append_dims
from .discretization import LegacyDDPMDiscretization
from .preconditioning import EpsPreconditioning


class DiscreteDenoiser:
    """Quantizes σ to the nearest entry of the discretization's table; with
    ``quantize_c_noise`` the network sees the table index as its timestep."""

    def __init__(self, preconditioning: EpsPreconditioning, num_idx: int,
                 discretization: LegacyDDPMDiscretization, quantize_c_noise: bool = True,
                 flip: bool = False, device: DeviceLike = None):
        self.preconditioning = preconditioning
        self.num_idx = num_idx
        self.quantize_c_noise = quantize_c_noise
        self.sigmas = discretization(num_idx, flip=flip, device=resolve_device(device))

    def sigma_to_idx(self, sigma: torch.Tensor) -> torch.Tensor:
        dists = sigma - self.sigmas.reshape((-1,) + (1,) * sigma.ndim)
        return dists.abs().argmin(dim=0).reshape(sigma.shape)

    def __call__(self, network_apply, inputs: torch.Tensor, sigma: torch.Tensor, cond: dict,
                 output_mode: str = "D") -> torch.Tensor:
        sigma = self.sigmas[self.sigma_to_idx(sigma)]
        c_skip, c_out, c_in, c_noise = self.preconditioning(append_dims(sigma, inputs.ndim))
        c_noise = c_noise.reshape(sigma.shape)
        if self.quantize_c_noise:
            c_noise = self.sigma_to_idx(c_noise)
        net = network_apply(inputs * c_in.to(inputs.dtype), c_noise, cond)
        if output_mode == "F":
            return net
        return net * c_out.to(inputs.dtype) + inputs * c_skip.to(inputs.dtype)
