"""EMA of the trainable parameters (port of neurosis_tpu/modules/ema.py, LitEma).

The shadow copies are fp32 tensors updated in place after each optimizer
step (the JAX version returns a new pytree; in place saves a copy). Shadows
of parameters that FSDP2 shards are DTensors laid out as their parameters,
and the update, elementwise, runs on each rank's own part.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..parallel.fsdp import is_dtensor


@dataclasses.dataclass
class EmaState:
    params: list  # fp32 shadow tensors, one per trainable parameter
    num_updates: int  # -1 disables the warmup decay


def ema_init(params, use_num_updates: bool = True) -> EmaState:
    shadow = [p.detach().float().clone() for p in params]
    return EmaState(shadow, 0 if use_num_updates else -1)


@torch.no_grad()
def ema_update(state: EmaState, params, decay: float = 0.9999) -> EmaState:
    """decay min(decay, (1+n)/(10+n)) with n counting updates, then
    shadow ← shadow − (1−d)·(shadow − param)."""
    n = state.num_updates + 1 if state.num_updates >= 0 else state.num_updates
    if n >= 0:
        d = np.minimum(np.float32(decay), (np.float32(1.0) + n) / (np.float32(10.0) + n))
    else:
        d = np.float32(decay)
    one_minus = float(np.float32(1.0) - np.float32(d))
    for s, p in zip(state.params, params):
        if is_dtensor(s):
            s, p = s.to_local(), p.to_local()
        s.sub_((s - p.float()) * one_minus)
    state.num_updates = n
    return state


@contextlib.contextmanager
def ema_swapped_in(state: EmaState, params):
    """``params`` hold the EMA shadows inside the block and their own values
    again after it (LitEma's store, copy_to and restore)."""
    saved = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p, s in zip(params, state.params):
            p.copy_(s)
    try:
        yield
    finally:
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
