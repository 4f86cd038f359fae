"""Elementary losses (port of neurosis_tpu/losses/functions.py). The batch
losses reduce every dim but the leading one and return a (B,) vector."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _reduce_all_but_batch(x: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    dims = tuple(range(1, x.ndim))
    if reduction == "mean":
        return x.mean(dim=dims)
    if reduction == "sum":
        return x.sum(dim=dims)
    raise ValueError(f"unknown reduction {reduction!r}")


def batch_l1_loss(outputs: torch.Tensor, target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return _reduce_all_but_batch((outputs - target).abs(), reduction)


def batch_mse_loss(outputs: torch.Tensor, target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return _reduce_all_but_batch((outputs - target).square(), reduction)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    """Hinge discriminator loss (reference functions.py:21-33)."""
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    """Softplus discriminator loss (functions.py:36-48)."""
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def get_discr_loss_fn(name: str):
    name = str(name).lower()
    if name == "hinge":
        return hinge_d_loss
    if name == "vanilla":
        return vanilla_d_loss
    raise ValueError(f"unknown discriminator loss {name!r}")
