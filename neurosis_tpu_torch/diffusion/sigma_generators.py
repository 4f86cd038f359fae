"""Train-time σ sampling (port of neurosis_tpu/diffusion/sigma_generators.py)."""

from __future__ import annotations

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .discretization import LegacyDDPMDiscretization


class DiscreteSigmaGenerator:
    """Uniform index into the flipped σ table. ``exclude_zero`` (default True,
    the JAX package's documented deviation) drops the table's leading σ=0,
    which eps weighting turns into a NaN loss. A fractional t in [0, 1) maps
    to index floor(t·num_idx); an integer t ≥ 1 is an index."""

    def __init__(self, discretization: LegacyDDPMDiscretization, num_idx: int = 1000,
                 flip: bool = True, exclude_zero: bool = True, device: DeviceLike = None):
        self.num_idx = num_idx
        table = discretization.table(num_idx, flip=flip)
        if exclude_zero and table.shape[0] > num_idx and table[0] == 0.0:
            table = table[1:]
        self.sigmas = torch.as_tensor(np.ascontiguousarray(table), device=resolve_device(device))

    def __call__(self, n_samples: int, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        idx = torch.where((t >= 0.0) & (t < 1.0), torch.floor(t * self.num_idx), t).to(torch.int64)
        return self.sigmas[idx.clamp(0, self.num_idx - 1)]
