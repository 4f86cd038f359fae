"""Adafactor with the fairseq relative-step schedule (port of
neurosis_tpu/optimizers/adafactor.py).

The update is optax.adafactor's, which the JAX package wraps, not
torch.optim.Adafactor's (their maths differ): factored second moments with
decay 1 − (t+1)^−0.8, block-RMS clipping, the relative step
min(1e-2, 1/√t) (warmup_init: min(1e-6·t, 1/√t)) and, with
``scale_parameter``, the parameter's own RMS (at least 1e-3) as a scale.
Every 2-D or larger parameter is factored over its two largest axes,
chosen in the JAX layout (HWIO for convolutions) so the factoring matches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def relative_step(step: int, warmup_init: bool) -> float:
    """HF/fairseq ``_get_lr`` relative step size, in fp32 as in JAX."""
    t = np.float32(max(step, 1))
    rel = np.minimum(np.float32(1e-6) * t, np.float32(1.0) / np.sqrt(t)) if warmup_init else \
        np.minimum(np.float32(1e-2), np.float32(1.0) / np.sqrt(t))
    return float(rel)


def _factored_dims(shape: tuple) -> Optional[tuple[int, int]]:
    """(d1, d0) torch axes of the second largest and the largest dim, picked
    as optax does (np.argsort, min_dim_size_to_factor=2) on the JAX layout."""
    if len(shape) < 2:
        return None
    # torch axis of each JAX-layout axis: OIHW → HWIO; (out, in) ↔ (in, out)
    # factors symmetrically, so 2-D and other ranks keep their order
    to_torch = (2, 3, 1, 0) if len(shape) == 4 else tuple(range(len(shape)))
    jax_shape = tuple(shape[a] for a in to_torch)
    order = np.argsort(jax_shape)
    if jax_shape[order[-2]] < 2:
        return None
    return to_torch[int(order[-2])], to_torch[int(order[-1])]


class Adafactor(torch.optim.Optimizer):
    """Config surface of the reference's Adafactor; momentum (beta1) and
    weight decay are not part of this port yet and raise."""

    def __init__(self, params, lr: Optional[float] = None, eps: tuple = (1e-30, 1e-3),
                 clip_threshold: float = 1.0, decay_rate: float = -0.8, beta1: Optional[float] = None,
                 weight_decay: float = 0.0, scale_parameter: bool = True, relative_step: bool = True,
                 warmup_init: bool = False):
        if lr is not None and relative_step:
            raise ValueError("Cannot combine manual `lr` and `relative_step=True` options")
        if warmup_init and not relative_step:
            raise ValueError("`warmup_init=True` requires `relative_step=True`")
        if beta1 is not None or weight_decay > 0.0:
            raise NotImplementedError("Adafactor momentum and weight decay are not ported yet")
        defaults = dict(lr=lr, eps=eps[0], clip_threshold=clip_threshold, decay_rate=abs(decay_rate),
                        scale_parameter=scale_parameter, relative_step=relative_step,
                        warmup_init=warmup_init)
        super().__init__(params, defaults)
        self.count = 0  # completed updates

    @torch.no_grad()
    def step(self, closure=None):
        step = self.count
        for group in self.param_groups:
            decay = float(np.float32(1.0) - np.float32(step + 1) ** np.float32(-group["decay_rate"]))
            lr = relative_step(step, group["warmup_init"]) if group["relative_step"] else group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                self._update(p, p.grad.float(), self.state[p], decay, lr, group)
        self.count += 1

    @staticmethod
    def _update(p, g, state, decay, lr, group):
        g2 = g * g + group["eps"]
        dims = _factored_dims(tuple(p.shape))
        if dims is not None:
            d1, d0 = dims
            if not state:
                state["v_row"] = torch.zeros_like(g2.mean(dim=d0))
                state["v_col"] = torch.zeros_like(g2.mean(dim=d1))
            v_row = state["v_row"].mul_(decay).add_(g2.mean(dim=d0), alpha=1.0 - decay)
            v_col = state["v_col"].mul_(decay).add_(g2.mean(dim=d1), alpha=1.0 - decay)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
            u = g * row_factor.unsqueeze(d0) * (v_col**-0.5).unsqueeze(d1)
        else:
            if not state:
                state["v"] = torch.zeros_like(g2)
            v = state["v"].mul_(decay).add_(g2, alpha=1.0 - decay)
            u = g * v**-0.5
        u = u / torch.clamp_min(torch.sqrt(torch.mean(u * u)) / group["clip_threshold"], 1.0)
        u = u * lr
        if group["scale_parameter"]:
            u = u * torch.sqrt(torch.clamp_min(torch.mean(p.float() ** 2), 1e-3**2))
        p.sub_(u.to(p.dtype))
