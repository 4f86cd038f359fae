"""Standard diffusion training loss (port of neurosis_tpu/diffusion/loss.py).

Randomness (the per-sample uniform t, the noise and the noise offset's
draws) comes from an explicit ``torch.Generator``; tests pass ``t``,
``noise`` and ``offset`` in so the port and the JAX package see the same
draws.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..losses.functions import batch_l1_loss, batch_mse_loss
from ..parallel import rows
from ..utils import append_dims
from .denoiser import Denoiser
from .sigma_generators import SigmaGenerator
from .weighting import DenoiserWeighting


class StandardDiffusionLoss:
    """Per-sample weighted L1 or L2 loss of one of two objectives:

    - ``edm``: z = x + σ·n, loss = w(σ)·‖D(z; σ) − x‖;
    - ``rf`` (rectified flow): z = (1−σ)·x + σ·n, loss = w(σ)·‖F(z; σ) − n‖,
      F the network's raw output.

    ``noise_offset`` adds offset·N(0, 1) per (sample, row) to the noise with
    probability ``noise_offset_chance``: JAX draws the offset over NHWC
    latents' first two axes, and so does the port. Both are clamped to
    [0, 1]. ``input_keys`` name batch entries passed on to the network;
    ``snr_gamma`` is kept and not read, as in JAX (min-SNR is the
    ``MinSNRGammaModifier`` weighting)."""

    def __init__(self, sigma_generator: SigmaGenerator, loss_weighting: DenoiserWeighting, loss_type: str = "l2",
                 snr_gamma: float = 0.0, noise_offset: float = 0.0, noise_offset_chance: float = 0.0,
                 input_keys: Union[str, Sequence[str]] = (), objective_type: str = "edm"):
        self.sigma_generator = sigma_generator
        self.loss_weighting = loss_weighting
        self.snr_gamma = snr_gamma
        self.noise_offset = min(max(noise_offset, 0.0), 1.0)
        self.noise_offset_chance = min(max(noise_offset_chance, 0.0), 1.0)
        self.objective_type = str(objective_type).lower()
        if self.objective_type not in ("edm", "rf"):
            raise ValueError(f"unknown objective type {objective_type!r}")
        loss_type = str(loss_type).lower()
        if loss_type == "l1":
            self.loss_type, self.loss = "l1", batch_l1_loss
        elif loss_type in ("l2", "mse"):
            self.loss_type, self.loss = "l2", batch_mse_loss
        else:
            raise ValueError(f"unknown loss type {loss_type!r}")
        self.input_keys = {input_keys} if isinstance(input_keys, str) else set(input_keys)

    def draw_offset(self, inputs: torch.Tensor, generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
        """The offset draw, zeroed when the chance says no (a device-side
        choice, no sync); None when the offset is off."""
        if self.noise_offset <= 0 or self.noise_offset_chance <= 0:
            return None
        shape = inputs.shape[:2] + (1,) * (inputs.ndim - 2)
        offset = rows.draw(torch.randn, shape, generator=generator, device=inputs.device, dtype=inputs.dtype)
        if self.noise_offset_chance < 1.0:
            take = torch.rand((), generator=generator, device=inputs.device) < self.noise_offset_chance
            offset = offset * take.to(offset.dtype)
        return offset

    def __call__(self, network_apply, denoiser: Denoiser, cond: dict, inputs: torch.Tensor,
                 generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None, batch: Optional[dict] = None,
                 offset: Optional[torch.Tensor] = None):
        """Per-sample weighted loss (B,); draws t ~ U[0,1), the noise and the
        offset (``draw_offset``) from ``generator`` unless given. A given
        ``offset`` is the draw with the chance already applied (zero when not
        taken)."""
        batch = batch or {}
        extra = {k: batch[k] for k in batch if k in self.input_keys}
        b = inputs.shape[0]
        if t is None:
            t = rows.draw(torch.rand, (b,), generator=generator, device=inputs.device)
        sigmas = self.sigma_generator(b, t).to(inputs.dtype)
        if noise is None:
            noise = rows.draw(torch.randn, inputs.shape, generator=generator, device=inputs.device,
                              dtype=inputs.dtype)
        if offset is None:
            offset = self.draw_offset(inputs, generator)
        if offset is not None and self.noise_offset > 0:
            noise = noise + self.noise_offset * offset.to(noise.dtype)
        sigmas_bc = append_dims(sigmas, inputs.ndim)
        weight = self.loss_weighting(sigmas)
        if self.objective_type == "rf":
            z_t = (1.0 - sigmas_bc) * inputs + sigmas_bc * noise
            loss = self.get_loss(denoiser(network_apply, z_t, sigmas, cond, "F", **extra), noise, weight)
        else:
            z_t = inputs + sigmas_bc * noise
            loss = self.get_loss(denoiser(network_apply, z_t, sigmas, cond, "D", **extra), inputs, weight)
        return loss

    def get_loss(self, outputs: torch.Tensor, target: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        return self.loss(outputs.float(), target.float()) * weight.float()
