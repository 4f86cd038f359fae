"""Diagonal Gaussian over VAE moments (port of neurosis_tpu/modules/distributions.py).

Channel-last moments [..., 2C] split into mean and logvar. ``sample`` takes
its noise explicitly (``eps``) or draws it from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..parallel import rows


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor, clip: bool = True) -> "DiagonalGaussian":
        mean, logvar = moments.chunk(2, dim=-1)
        if clip:
            logvar = logvar.clamp(-30.0, 20.0)
        return cls(mean, logvar)

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std·eps, with ``eps`` given or drawn from ``generator``."""
        if eps is None:
            eps = rows.draw(torch.randn, self.mean.shape, generator=generator, dtype=self.mean.dtype,
                            device=self.mean.device)
        return self.mean + self.std * eps.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL to N(0, I) per batch element, summed over the other dims."""
        dims = tuple(range(1, self.mean.ndim))
        return 0.5 * (self.mean.square() + torch.exp(self.logvar) - 1.0 - self.logvar).sum(dim=dims)
