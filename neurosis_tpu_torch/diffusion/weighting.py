"""Loss weightings w(σ) (port of neurosis_tpu/diffusion/weighting.py)."""

from __future__ import annotations

import torch


class EpsWeighting:
    def __call__(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma**-2.0
