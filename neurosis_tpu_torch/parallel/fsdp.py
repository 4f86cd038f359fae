"""FSDP2 over the (data, fsdp[, context]) mesh (port of neurosis_tpu/parallel/fsdp.py).

``wrap_engine`` applies ``fully_shard`` to the units the reference's
``DiffusionFsdpPolicy`` names (fsdp/diffusionpolicy.py:43-146): each layer
of the UNet's input, middle and output blocks (its ResBlocks, its
SpatialTransformers, its resamplers), then the UNet itself; each trainable
text tower; the VAE trainer's Encoder, Decoder, discriminator and a
codebook module. Over a mesh with data and fsdp both > 1 that is HSDP:
parameters shard over ``fsdp`` and replicate over ``data``; a data axis of
one is plain FSDP, an fsdp axis of one is DDP, through one code path.
With a context axis the parameters replicate over data × context: HSDP's
replicate dimension is then the data and context indices flattened, a
(data·context, fsdp) mesh over the same ranks (``Mesh.fsdp_mesh``, replicate
index d·C + c). Gradients are reduced in their own dtype (fp32: the port's
parameters are fp32 in every precision) and averaged over all ranks, which
is the one-card gradient of the global batch's mean loss
(``parallel/mesh.py``): the context ranks of one data index hold the same
rows and, after the ring's gathers, compute the same gradients, so their
share of the average changes nothing.

Frozen modules (the first stage, frozen towers, LPIPS) take no gradient
and stay whole on each rank. JAX's PartitionSpecs are a layout choice of
XLA and are not copied: where a parameter is split changes no number.

A wrapped root (the UNet, the Encoder) keeps its parameters gathered after
a forward until its backward, and after a forward without one (sampling,
an eval, the VAE's discriminator step) until ``reshard``: the trainer
reshards before each step and the engines' EMA scopes around their swap, so
that the parameters a step or a swap takes are the sharded ones. The
decoder's last conv weight, whose two gradients the adaptive GAN weight
takes, is thus the gathered one in the step's graph.

The parameters become DTensors. ``full`` and ``assign`` move between a
DTensor and the whole tensor a one-card run holds (checkpoints, EMA
saves), and ``shard_optimizer_state`` lays a whole optimizer state out over
its parameters' placements.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any

import torch
from torch import nn

logger = logging.getLogger(__name__)

# attributes the port's layers set on a parameter, which the optimizers read
_PARAM_ATTRS = ("jax_layout",)


def is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor (a collective for a DTensor; every rank calls it)."""
    return t.full_tensor() if is_dtensor(t) else t


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` for a whole ``src``: a DTensor ``dst`` takes its own
    part of it (every rank holds the same ``src``; no communication)."""
    with torch.no_grad():
        if is_dtensor(dst):
            from torch.distributed.tensor import distribute_tensor

            src = distribute_tensor(src.to(device=dst.device, dtype=dst.dtype), dst.device_mesh, dst.placements,
                                    src_data_rank=None)
        dst.copy_(src)


def _units(engine) -> list:
    """The modules to wrap, innermost first, each trainable one."""
    if hasattr(engine, "conditioner"):
        unet = engine.model
        units = [layer for blocks in (unet.input_blocks, unet.output_blocks) for blk in blocks for layer in blk]
        units += list(unet.middle_block) + [unet]
        units += [e for e in engine.conditioner.embedders if any(p.requires_grad for p in e.parameters())]
        return units
    units = [m for m, frozen in ((engine.encoder, engine.freeze_encoder), (engine.decoder, engine.freeze_decoder))
             if not frozen]
    if engine.discriminator is not None:
        units.append(engine.discriminator)
    if isinstance(engine.regularizer, nn.Module) and any(True for _ in engine.regularizer.parameters()):
        units.append(engine.regularizer)
    return units


def wrap_engine(engine, mesh) -> list:
    """``fully_shard`` the engine's trainable units over ``mesh.fsdp_mesh``
    in place (before its optimizer is built); returns the units. A unit
    that cannot be wrapped raises: the run never trains unwrapped."""
    from torch.distributed.fsdp import fully_shard

    units = _units(engine)
    attrs = {}
    for unit in units:
        for name, p in unit.named_parameters():
            for a in _PARAM_ATTRS:
                if hasattr(p, a):
                    attrs[(id(unit), name, a)] = getattr(p, a)
    for unit in units:
        fully_shard(unit, mesh=mesh.fsdp_mesh)
    for unit in units:
        for name, p in unit.named_parameters():
            for a in _PARAM_ATTRS:
                if (id(unit), name, a) in attrs:
                    setattr(p, a, attrs[(id(unit), name, a)])
    engine.fsdp_units = units
    logger.info(f"FSDP2 over mesh data={mesh.data} x fsdp={mesh.fsdp} x context={mesh.context}: "
                f"{len(units)} units")
    return units


def reshard(engine) -> None:
    """Register the sharded parameters of every wrapped unit again (no-op
    for an engine that is not wrapped)."""
    for unit in getattr(engine, "fsdp_units", ()):
        unit.reshard()


@contextlib.contextmanager
def resharded(engine):
    """``reshard`` on entering and on leaving the block."""
    reshard(engine)
    try:
        yield
    finally:
        reshard(engine)


def full_state(tree: Any) -> Any:
    """A state dict (nested dicts, lists, tensors) with every DTensor made whole."""
    if isinstance(tree, dict):
        return {k: full_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_state(v) for v in tree)
    return full(tree) if is_dtensor(tree) else tree


def shard_optimizer_state(optimizer: torch.optim.Optimizer, state_dict: dict) -> dict:
    """A whole optimizer ``state_dict`` laid out for ``optimizer``'s
    DTensor parameters: a state tensor of its parameter's shape takes the
    parameter's placements, any other one (factored moments) is replicated,
    0-d ones stay as they are. An optimizer that keeps its state whole
    (``full_layout``) takes it as it is."""
    if getattr(optimizer, "full_layout", False):
        return state_dict
    from torch.distributed.tensor import Replicate, distribute_tensor

    params = [p for group in optimizer.param_groups for p in group["params"]]
    out = {}
    for index, st in state_dict["state"].items():
        p = params[int(index)]
        if not is_dtensor(p):
            out[index] = st
            continue
        row = {}
        for k, v in st.items():
            if isinstance(v, torch.Tensor) and v.ndim > 0 and not is_dtensor(v):
                placements = p.placements if tuple(v.shape) == tuple(p.shape) else \
                    [Replicate()] * p.device_mesh.ndim
                v = distribute_tensor(v.to(p.device), p.device_mesh, placements, src_data_rank=None)
            row[k] = v
        out[index] = row
    return dict(state_dict, state=out)
