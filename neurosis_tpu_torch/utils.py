"""Small tensor helpers (port of neurosis_tpu/utils/misc.py)."""

from __future__ import annotations

import torch


def append_dims(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Append trailing singleton dims until ``x.ndim == target_ndim``."""
    extra = target_ndim - x.ndim
    if extra < 0:
        raise ValueError(f"input has {x.ndim} dims but target_ndim is {target_ndim}, which is less")
    return x.reshape(x.shape + (1,) * extra)
