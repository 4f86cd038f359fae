"""AdamW with optax's defaults (the VAE configs' ``optax.adamw``).

The update math of ``torch.optim.AdamW`` is optax's: bias-corrected m̂, v̂,
m̂/(√v̂ + eps), and decoupled decay lr·wd·p. Only the defaults differ:
optax decays by 1e-4 where torch's default is 1e-2.
"""

from __future__ import annotations

import torch


def adamw(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """optax.adamw's signature (``learning_rate``, as the configs name it)."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay)
