"""optax's ``adam``, ``adamw`` and ``sgd`` as torch optimizers.

The JAX package trains every ``optax.adam``/``adamw``/``sgd`` node, and the
``torch.optim.Adam``/``AdamW``/``SGD`` paths it maps to them, with optax's
transforms. These classes compute the same chains, leaf by leaf in the same
order of operations, over multi-tensor ``torch._foreach_*`` ops:

- ``scale_by_adam``: μ ← (1−b1)·g + b1·μ, ν ← (1−b2)·g² + b2·ν, then
  μ̂/(√(ν̂ + eps_root) + eps) with the bias corrections 1 − b^count; with
  ``nesterov``, μ̂ = b1·μ/(1−b1^(count+1)) + (1−b1)·g/(1−b1^count). μ is
  kept in ``mu_dtype`` after the step (the update uses it before the cast);
- ``add_decayed_weights``: + weight_decay·p (``adamw`` only);
- ``trace`` (``sgd`` with ``momentum``): t ← g + momentum·t, the update
  t (or g + momentum·t with ``nesterov``), t kept in ``accumulator_dtype``;
- ``scale_by_learning_rate``: × −lr, added to p.

Each param group's ``lr`` is the learning rate, so a schedule
(``schedulers.attach_schedule``) and a group's ``lr_scale`` apply as to any
torch optimizer. optax's ``mask`` is not taken (ROADMAP Queue 1 item 8).

Every op is elementwise, so on parameters that FSDP2 shards (DTensors) the
chains run on each rank's own part of the parameters, grads and moments,
in place (the moments stay DTensors): the same numbers as on the whole
leaf, without a DTensor dispatch per op.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..parallel.fsdp import is_dtensor

DtypeLike = Union[None, str, torch.dtype]


def as_dtype(dtype: DtypeLike) -> Optional[torch.dtype]:
    """A dtype as optax's ``canonicalize_dtype`` takes one: None, a torch
    dtype, or a name (``bfloat16``, ``jnp.bfloat16``, ``float32``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).rsplit(".", 1)[-1]
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def _bias_correction(decay: float, count: int) -> float:
    """1 − decay^count in fp32, as optax computes it."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one - torch.tensor(decay, dtype=torch.float32) ** count)


def _scaled_in_own_dtype(tensors: list, scalar: float) -> list:
    """scalar·t in t's dtype, the scalar first rounded to it (JAX's weak
    typing: 0.9 times a bf16 moment is bf16(0.9) = 0.8984375 times it)."""
    return [t * torch.tensor(scalar, dtype=t.dtype).item() for t in tensors]


def _local(tensors: list) -> list:
    """Each DTensor's own part (a view: in-place ops update the DTensor)."""
    return [t.to_local() if is_dtensor(t) else t for t in tensors]


def _with_grads(group: dict) -> tuple[list, list]:
    params = [p for p in group["params"] if p.grad is not None]
    return params, [p.grad for p in params]


def _apply(params: list, updates: list, lr: float) -> None:
    """p ← p + (−lr)·u (``scale_by_learning_rate`` then ``apply_updates``;
    the updates are in the grads' dtype, which is the parameters')."""
    torch._foreach_mul_(updates, -lr)
    torch._foreach_add_(params, updates)


class OptaxAdam(torch.optim.Optimizer):
    """optax ``chain(scale_by_adam, add_decayed_weights, scale_by_learning_rate)``."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, weight_decay: float = 0.0, mu_dtype: DtypeLike = None,
                 nesterov: bool = False):
        defaults = dict(lr=lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root, weight_decay=weight_decay,
                        mu_dtype=as_dtype(mu_dtype), nesterov=nesterov)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params, grads = _with_grads(group)
            if not params:
                continue
            b1, b2 = group["b1"], group["b2"]
            for p in params:
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p, dtype=group["mu_dtype"] or p.dtype)
                    st["nu"] = torch.zeros_like(p)
                st["count"] += 1
            count = self.state[params[0]]["count"]
            mus = _local([self.state[p]["mu"] for p in params])
            nus = _local([self.state[p]["nu"] for p in params])
            params, grads = _local(params), _local(grads)
            # b1·μ in mu_dtype (optax's weak-typed scalar takes μ's dtype, b1
            # rounded to it), the sum in the grads' dtype, stored back in
            # mu_dtype after the step
            cast = any(m.dtype != g.dtype for m, g in zip(mus, grads))
            if cast:
                mu = [m.to(g.dtype) for m, g in zip(_scaled_in_own_dtype(mus, b1), grads)]
            else:
                mu = mus
                torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
            if group["nesterov"]:
                mu_hat = torch._foreach_mul(torch._foreach_div(mu, _bias_correction(b1, count + 1)), b1)
                torch._foreach_add_(mu_hat, torch._foreach_mul(
                    torch._foreach_div(grads, _bias_correction(b1, count)), 1.0 - b1))
            else:
                mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
            den = torch._foreach_div(nus, _bias_correction(b2, count))
            if group["eps_root"]:
                torch._foreach_add_(den, group["eps_root"])
            den = torch._foreach_sqrt(den)
            torch._foreach_add_(den, group["eps"])
            updates = torch._foreach_div(mu_hat, den)
            if group["weight_decay"]:
                torch._foreach_add_(updates, torch._foreach_mul(params, group["weight_decay"]))
            if cast:
                for m, m32 in zip(mus, mu):
                    m.copy_(m32)
            _apply(params, updates, group["lr"])
        return loss


class OptaxSGD(torch.optim.Optimizer):
    """optax ``chain(trace or identity, scale_by_learning_rate)``."""

    def __init__(self, params, lr: float, momentum: Optional[float] = None, nesterov: bool = False,
                 accumulator_dtype: DtypeLike = None):
        defaults = dict(lr=lr, momentum=momentum, nesterov=nesterov, accumulator_dtype=as_dtype(accumulator_dtype))
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params, grads = _with_grads(group)
            if not params:
                continue
            decay = group["momentum"]
            if decay is None:
                _apply(_local(params), [g.clone() for g in _local(grads)], group["lr"])
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p]["trace"] = torch.zeros_like(p, dtype=group["accumulator_dtype"] or p.dtype)
            stored = _local([self.state[p]["trace"] for p in params])
            params, grads = _local(params), _local(grads)
            trace = torch._foreach_add(grads, [t.to(g.dtype) for t, g in zip(_scaled_in_own_dtype(stored, decay),
                                                                              grads)])
            updates = torch._foreach_add(grads, torch._foreach_mul(trace, decay)) if group["nesterov"] \
                else [t.clone() for t in trace]
            for t, new in zip(stored, trace):
                t.copy_(new)
            _apply(params, updates, group["lr"])
        return loss


def adam(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0, mu_dtype: DtypeLike = None, nesterov: bool = False) -> OptaxAdam:
    """optax.adam's signature."""
    return OptaxAdam(params, learning_rate, b1, b2, eps, eps_root, 0.0, mu_dtype, nesterov)


def adamw(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, mu_dtype: DtypeLike = None, weight_decay: float = 1e-4,
          nesterov: bool = False) -> OptaxAdam:
    """optax.adamw's signature (without ``mask``): decay 1e-4 by default."""
    return OptaxAdam(params, learning_rate, b1, b2, eps, eps_root, weight_decay, mu_dtype, nesterov)


def sgd(params, learning_rate: float, momentum: Optional[float] = None, nesterov: bool = False,
        accumulator_dtype: DtypeLike = None) -> OptaxSGD:
    """optax.sgd's signature."""
    return OptaxSGD(params, learning_rate, momentum, nesterov, accumulator_dtype)
