"""CAME, the confidence-guided memory-efficient optimizer (port of
neurosis_tpu/optimizers/came.py; the configs name it
``neurosis.optimizers.CAME``).

Per leaf, with betas (b1, b2, b3), eps1 = 1e-30 and eps2 = 1e-16:

  v ← b2·v + (1−b2)·(g² + eps1)       factored into row and column means
                                       for leaves of rank ≥ 2
  u = g/√v, then u / max(1, rms(u)/clip_threshold)
  m ← b1·m + (1−b1)·u
  r ← b3·r + (1−b3)·((u − m)² + eps2)  the confidence statistic, factored alike
  p ← p − lr·m/√r − lr·weight_decay·p

A factored moment V is row ⊗ col / mean(row), row and col being the means
of the last and of the second-to-last axis. The axes are those of the leaf
in the JAX package's layout (a parameter's ``jax_layout``, set by the
port's Dense and Conv2d: JAX's kernels are (in, out) and HWIO), so the rows
and columns are JAX's and not those of torch's OIHW. Plain torch, leaf by
leaf, as the JAX version is jnp. On a parameter that FSDP2 shards (a
DTensor) every op runs on DTensors, so the means and the RMS are over the
whole leaf.
"""

from __future__ import annotations

import torch


def _jax_view(t: torch.Tensor, perm) -> torch.Tensor:
    return t.permute(*perm) if perm is not None else t


def _torch_view(t: torch.Tensor, perm) -> torch.Tensor:
    if perm is None:
        return t
    inverse = [0] * len(perm)
    for i, axis in enumerate(perm):
        inverse[axis] = i
    return t.permute(*inverse)


def _scaled(s: torch.Tensor, row: torch.Tensor, col: torch.Tensor, eps1: float) -> torch.Tensor:
    """s · rsqrt(row / max(mean(row), eps1)) · rsqrt(col), row and col
    broadcast over the last and the second-to-last axis."""
    r = row / row.mean(dim=-1, keepdim=True).clamp_min(eps1)
    return s * torch.rsqrt(r).unsqueeze(-1) * torch.rsqrt(col).unsqueeze(-2)


class CAME(torch.optim.Optimizer):
    """JAX's ``came`` signature; ``learning_rate`` is each param group's ``lr``."""

    def __init__(self, params, learning_rate: float = 2e-4, betas=(0.9, 0.999, 0.9999), weight_decay: float = 0.0,
                 clip_threshold: float = 1.0, eps1: float = 1e-30, eps2: float = 1e-16):
        super().__init__(params, dict(lr=learning_rate, betas=tuple(betas), weight_decay=weight_decay,
                                      clip_threshold=clip_threshold, eps1=eps1, eps2=eps2))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2, b3 = group["betas"]
            eps1, eps2, lr = group["eps1"], group["eps2"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                perm = getattr(p, "jax_layout", None)
                g = _jax_view(p.grad, perm).float()
                factored = g.ndim >= 2
                st = self.state[p]
                g2 = g.square() + eps1
                if not st:  # zeros_like of a reduction: a DTensor's state keeps its mesh
                    st["m"] = torch.zeros_like(g)
                    if factored:
                        for name in ("v_row", "r_row"):
                            st[name] = torch.zeros_like(g2.mean(dim=-1))
                        for name in ("v_col", "r_col"):
                            st[name] = torch.zeros_like(g2.mean(dim=-2))
                    else:
                        st["v_row"], st["r_row"] = torch.zeros_like(g), torch.zeros_like(g)
                if factored:
                    st["v_row"].mul_(b2).add_(g2.mean(dim=-1) * (1 - b2))
                    st["v_col"].mul_(b2).add_(g2.mean(dim=-2) * (1 - b2))
                    u = _scaled(g, st["v_row"], st["v_col"], eps1)
                else:
                    st["v_row"].mul_(b2).add_(g2 * (1 - b2))
                    u = g * torch.rsqrt(st["v_row"])
                u = u / torch.clamp_min(u.square().mean().sqrt() / group["clip_threshold"], 1.0)
                m = st["m"].mul_(b1).add_(u * (1 - b1))
                res = (u - m).square() + eps2
                if factored:
                    st["r_row"].mul_(b3).add_(res.mean(dim=-1) * (1 - b3))
                    st["r_col"].mul_(b3).add_(res.mean(dim=-2) * (1 - b3))
                    upd = _scaled(m, st["r_row"], st["r_col"], eps1)
                else:
                    st["r_row"].mul_(b3).add_(res * (1 - b3))
                    upd = m * torch.rsqrt(st["r_row"])
                step = upd * -lr
                if group["weight_decay"] > 0:
                    step = step - (lr * group["weight_decay"]) * _jax_view(p, perm).float()
                p.add_(_torch_view(step, perm).to(p.dtype))
        return loss
