"""Denoiser preconditioning (port of neurosis_tpu/diffusion/preconditioning.py)."""

from __future__ import annotations

import torch


class EpsPreconditioning:
    """Epsilon prediction (SD 1.x): c_skip = 1, c_out = −σ, c_in = 1/√(σ²+1),
    c_noise = σ. ``__call__(sigma) -> (c_skip, c_out, c_in, c_noise)``."""

    def __call__(self, sigma: torch.Tensor):
        return torch.ones_like(sigma), -sigma, 1.0 / torch.sqrt(sigma**2 + 1.0), sigma
