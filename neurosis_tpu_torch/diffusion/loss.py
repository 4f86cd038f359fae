"""Standard diffusion training loss (port of neurosis_tpu/diffusion/loss.py).

Randomness (the per-sample uniform t and the noise) comes from an explicit
``torch.Generator``; tests pass ``t`` and ``noise`` in directly so the
port and the JAX package see the same draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import append_dims
from .denoiser import DiscreteDenoiser
from .sigma_generators import DiscreteSigmaGenerator
from .weighting import EpsWeighting


def batch_mse_loss(outputs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((outputs - target) ** 2).mean(dim=tuple(range(1, outputs.ndim)))


class StandardDiffusionLoss:
    """EDM objective with L2 loss: z = x + σ·noise, loss = w(σ)·‖D(z; σ) − x‖²
    per sample. Noise offset and the L1 / rectified-flow variants come later."""

    def __init__(self, sigma_generator: DiscreteSigmaGenerator, loss_weighting: EpsWeighting):
        self.sigma_generator = sigma_generator
        self.loss_weighting = loss_weighting

    def __call__(self, network_apply, denoiser: DiscreteDenoiser, cond: dict, inputs: torch.Tensor,
                 generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-sample weighted loss (B,); draws t ~ U[0,1) and the noise from
        ``generator`` unless given."""
        b = inputs.shape[0]
        if t is None:
            t = torch.rand(b, generator=generator, device=inputs.device)
        if noise is None:
            noise = torch.randn(inputs.shape, generator=generator, device=inputs.device, dtype=inputs.dtype)
        sigmas = self.sigma_generator(b, t).to(inputs.dtype)
        z_t = inputs + append_dims(sigmas, inputs.ndim) * noise
        d_out = denoiser(network_apply, z_t, sigmas, cond, "D")
        weight = self.loss_weighting(sigmas)
        return batch_mse_loss(d_out.float(), inputs.float()) * weight.float()
