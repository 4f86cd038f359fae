"""Training state threaded through ``DiffusionEngine.train_step`` and the
VAE-GAN steps (port of neurosis_tpu/trainer/state.py and the VAETrainState
of trainer/vae_engine.py). The trainable parameters themselves live in the
engine's modules and are updated in place; so do the discriminator's
BatchNorm running statistics."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..modules.ema import EmaState


@dataclasses.dataclass
class TrainState:
    step: int
    optimizer: torch.optim.Optimizer
    ema: Optional[EmaState]
    generator: torch.Generator  # per-run source of the loss's t and noise draws


@dataclasses.dataclass
class VAETrainState:
    step: int
    g_optimizer: torch.optim.Optimizer  # encoder and decoder
    d_optimizer: Optional[torch.optim.Optimizer]  # the discriminator, None without one
    generator: torch.Generator  # per-run source of the posterior draws
    ema: Optional[EmaState] = None  # shadows of the encoder and decoder, with use_ema


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over all tensors, in fp32."""
    total = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    for t in tensors:
        total = total + t.float().square().sum()
    return total.sqrt()
