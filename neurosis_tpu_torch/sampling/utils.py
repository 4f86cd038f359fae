"""Sampler math utilities (port of neurosis_tpu/sampling/utils.py, to_d)."""

from __future__ import annotations

import torch

from ..utils import append_dims


def to_d(x: torch.Tensor, sigma: torch.Tensor, denoised: torch.Tensor) -> torch.Tensor:
    """Denoiser output → Karras ODE derivative."""
    return (x - denoised) / append_dims(sigma, x.ndim)
