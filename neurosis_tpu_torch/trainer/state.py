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
from ..parallel.fsdp import is_dtensor


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
    ema: Optional[EmaState] = None  # shadows of the generator's parameters, with use_ema
    reg_stats: Optional[dict] = None  # an EMA codebook's buffers by name (JAX's ema_stats), updated in place


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over all tensors, in fp32. DTensors (sharded gradients) add
    their local sums of squares, summed over the mesh dims they are sharded
    on in one all-reduce a mesh: the whole tensors' norm."""
    import torch.distributed as dist

    total = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    sharded: dict = {}
    for t in tensors:
        if is_dtensor(t):
            key = (id(t.device_mesh), tuple(i for i, p in enumerate(t.placements) if p.is_shard()))
            mesh, acc = sharded.get(key, (t.device_mesh, None))
            s = t.to_local().float().square().sum()
            sharded[key] = (mesh, s if acc is None else acc + s)
        else:
            total = total + t.float().square().sum()
    for (_, dims), (mesh, acc) in sharded.items():
        for d in dims:
            dist.all_reduce(acc, group=mesh.get_group(d))
        total = total + acc
    return total.sqrt()
