"""Parameter histograms on the ``trainer.wandb_watch_steps`` cadence (port of
JAX's ``Trainer._wandb_watch``, neurosis_tpu/trainer/loop.py:538-565).

JAX flattens ``state.params`` (the diffusion engine's ``model`` and
trainable ``conditioner``, or the VAE trainer's ``encoder``, ``decoder``,
``loss`` and ``regularizer``) in tree order, takes each leaf whole in its
own layout, subsamples a leaf of more than 4096 values as
``arr[::size // 4096]`` and concatenates the leaves of a group, the first
two parts of the leaf's path. A strided subsample of an OIHW kernel picks
other values than one of the HWIO kernel, so each leaf is taken here in
JAX's layout (the ``jax_layout`` the port's Dense and Conv2d set, which
``checkpoint/convert.py`` inverts) and in JAX's order: its dict keys sorted
at every level, which is the order of the dotted keys. A group's second
part is the JAX module's name: the port's path down to its first module
that is not a container (``input_blocks.1.0``, ``time_embed.0``; a holder
that JAX has no module for, marked ``flax_inline``, counts as a container:
``mid.attn_1``, ``down.0.block.1``), with a conditioner's ``embedders.N``
as flax's ``embedders_N``.

Leaves are gathered (a collective for a DTensor: every rank calls
``device_arrays``), laid out and subsampled on the device, and copied to
the host once a group.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from ..parallel.fsdp import full

_CONTAINERS = (nn.ModuleList, nn.Sequential, nn.ModuleDict)
_EMBEDDER = re.compile(r"^embedders\.(\d+)$")
MAX_VALUES = 4096


def jax_module_name(module: nn.Module, name: str) -> str:
    """The first part of the JAX path of ``module``'s parameter ``name``."""
    parts, mod = [], module
    for comp in name.split("."):
        parts.append(comp)
        child = mod._modules.get(comp)
        if child is None or not (isinstance(child, _CONTAINERS) or type(child) is nn.Module
                                 or getattr(child, "flax_inline", False)):
            break
        mod = child
    return _EMBEDDER.sub(r"embedders_\1", ".".join(parts))


def watched_parameters(engine) -> list:
    """(group, key, parameter) of JAX's ``state.params``, in its tree order."""
    from .callbacks import _named_params, engine_modules

    tops = engine_modules(engine)
    out = []
    for key, p in _named_params(engine):
        top, rest = key.split(".", 1)
        out.append((f"{top}/{jax_module_name(tops[top], rest)}", key, p))
    return sorted(out, key=lambda t: t[1])


def _jax_leaf(p: torch.Tensor) -> torch.Tensor:
    """The leaf flat in JAX's layout, subsampled as JAX does, on p's device."""
    t = full(p.detach())
    layout = getattr(p, "jax_layout", None)
    if layout is not None and t.ndim == len(layout):
        t = t.permute(*layout)
    flat = t.reshape(-1)
    if flat.numel() > MAX_VALUES:
        flat = flat[:: max(1, flat.numel() // MAX_VALUES)]
    return flat


def device_arrays(engine) -> dict:
    """{group: the group's values, fp32 on the device}, in JAX's order."""
    groups: dict = {}
    for group, _, p in watched_parameters(engine):
        groups.setdefault(group, []).append(_jax_leaf(p))
    return {g: torch.cat(v).float() for g, v in groups.items()}
